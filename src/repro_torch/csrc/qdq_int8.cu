// Block int8 quantize and dequantize: the DaeMon link compressor for the
// int8 pod-gradient sync of the train step.
//
//   quantize:   per row of B f32 values, amax = max |x|,
//               scale = amax / 127 (1.0 where amax is 0),
//               q = clamp(round-half-even(x / scale), -127, 127) as int8;
//   dequantize: out = (float(q) * scale[row]) as f32 or bf16.
//
// Replaces the TPU kernels repro/kernels/qdq_int8.py::quantize_block_int8
// (:34) and ::dequantize_block_int8 (:52), Pallas grids over (8, B) VMEM
// tiles that assert N % 8 == 0. Here any N is taken: the 8-row tile was a
// TPU sublane rule.
//
// On an H100 both passes are bound by bytes: quantize reads 4 B and
// writes 1 B per value and does a handful of operations on each, far
// below the ~20 operations per byte where the card's f32 units would
// become the limit. The designs therefore only keep the traffic at full
// width and touch each byte once:
// - quantize gives each row to one warp (8 rows per 256-thread block).
//   Lane l loads the row's float4 vectors l, l+32, ... (16-byte loads,
//   neighbouring lanes on neighbouring addresses), keeps them in
//   registers, reduces |x| to the row max with warp shuffles, and stores
//   its four int8 results per vector as one 32-bit word (128 contiguous
//   bytes per warp store). Nothing goes through shared memory and the row
//   is read once.
// - dequantize is elementwise: each thread turns 4 int8 (one 32-bit load)
//   into one 16-byte f32 store (or one 8-byte bf16 store), four such
//   words per thread in flight, the row scale read through the read-only
//   cache.
// Bit-exactness with the plain PyTorch version: the division is
// __fdiv_rn (IEEE, never a reciprocal multiply), rintf rounds half to
// even as torch.round does, and the build passes -fmad=false. Non-finite
// input follows the reference: the max propagates NaN as torch.amax does
// (so a row holding NaN gets scale 1, since amax > 0 fails), Inf / Inf
// and NaN quotients become q = 0, as the reference's float-to-int8
// convert makes them, and +-Inf at scale 1 clamps to +-127.
//
// Plain C interface, loaded with ctypes. Each launch allocates nothing,
// runs on the caller's stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a block width it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per quantize block
constexpr int kThreads = 32 * kWarps;
constexpr int kWordsPerThread = 4;        // dequantize ILP

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
    float t = rintf(__fdiv_rn(v, s));
    t = t != t ? 0.f : fminf(fmaxf(t, -127.f), 127.f);   // NaN -> 0
    return static_cast<uint32_t>(static_cast<uint8_t>(
        static_cast<int8_t>(static_cast<int>(t))));
}

// V float4 vectors per lane: a row holds B = 128 * V values.
template <int V>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float4* __restrict__ x, uint32_t* __restrict__ q,
                float* __restrict__ scale, long long rows) {
    const long long row = static_cast<long long>(blockIdx.x) * kWarps
        + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;              // whole warp leaves together
    const float4* src = x + row * (32 * V);
    float4 v[V];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
        v[j] = __ldg(src + j * 32 + lane);
        amax = nan_max(amax, fabsf(v[j].x));
        amax = nan_max(amax, fabsf(v[j].y));
        amax = nan_max(amax, fabsf(v[j].z));
        amax = nan_max(amax, fabsf(v[j].w));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    uint32_t* dst = q + row * (32 * V);
#pragma unroll
    for (int j = 0; j < V; ++j) {
        dst[j * 32 + lane] = quant_byte(v[j].x, s)
            | (quant_byte(v[j].y, s) << 8)
            | (quant_byte(v[j].z, s) << 16)
            | (quant_byte(v[j].w, s) << 24);
    }
    if (lane == 0) scale[row] = s;
}

__device__ __forceinline__ float dq(uint32_t w, int k, float s) {
    const int8_t b = static_cast<int8_t>((w >> (8 * k)) & 0xffu);
    return __fmul_rn(static_cast<float>(b), s);
}

__device__ __forceinline__ void store4(float* out, long long e, float a,
                                       float b, float c, float d) {
    *reinterpret_cast<float4*>(out + e) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long e,
                                       float a, float b, float c, float d) {
    const uint32_t lo = static_cast<uint32_t>(
        __bfloat16_as_ushort(__float2bfloat16_rn(a)))
        | (static_cast<uint32_t>(
            __bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
    const uint32_t hi = static_cast<uint32_t>(
        __bfloat16_as_ushort(__float2bfloat16_rn(c)))
        | (static_cast<uint32_t>(
            __bfloat16_as_ushort(__float2bfloat16_rn(d))) << 16);
    *reinterpret_cast<uint2*>(out + e) = make_uint2(lo, hi);
}

// Word w holds elements 4w..4w+3 of the flat (N, B) array; B % 4 == 0,
// so all four lie in row 4w / B.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint32_t* __restrict__ q,
                  const float* __restrict__ scale, OutT* __restrict__ out,
                  long long words, int words_per_row) {
    const long long base = static_cast<long long>(blockIdx.x)
        * (kThreads * kWordsPerThread) + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const long long w = base + k * kThreads;
        if (w < words) {
            const uint32_t word = __ldg(q + w);
            const float s = __ldg(scale + w / words_per_row);
            store4(out, 4 * w, dq(word, 0, s), dq(word, 1, s),
                   dq(word, 2, s), dq(word, 3, s));
        }
    }
}

template <int V>
void launch_quantize(const void* x, void* q, void* scale, long long rows,
                     cudaStream_t stream) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    quantize_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
        static_cast<const float4*>(x), static_cast<uint32_t*>(q),
        static_cast<float*>(scale), rows);
}

}  // namespace

// x (rows, block) f32 -> q (rows, block) int8, scale (rows,) f32.
extern "C" int quantize_block_int8_launch(const void* x, void* q,
                                          void* scale, long long rows,
                                          int block, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (rows > 0) {
        switch (block) {
            case 128: launch_quantize<1>(x, q, scale, rows, stream); break;
            case 256: launch_quantize<2>(x, q, scale, rows, stream); break;
            case 512: launch_quantize<4>(x, q, scale, rows, stream); break;
            case 1024: launch_quantize<8>(x, q, scale, rows, stream); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// q (rows, block) int8, scale (rows,) f32 -> out (rows, block) f32, or
// bf16 when out_bf16 != 0.
extern "C" int dequantize_block_int8_launch(const void* q, const void* scale,
                                            void* out, long long rows,
                                            int block, int out_bf16,
                                            void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (block != 128 && block != 256 && block != 512 && block != 1024)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long words = rows * (block / 4);
    if (words > 0) {
        const long long per_block = kThreads * kWordsPerThread;
        const unsigned blocks =
            static_cast<unsigned>((words + per_block - 1) / per_block);
        const uint32_t* qw = static_cast<const uint32_t*>(q);
        const float* sc = static_cast<const float*>(scale);
        if (out_bf16) {
            dequantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
                qw, sc, static_cast<__nv_bfloat16*>(out), words, block / 4);
        } else {
            dequantize_kernel<float><<<blocks, kThreads, 0, stream>>>(
                qw, sc, static_cast<float*>(out), words, block / 4);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
