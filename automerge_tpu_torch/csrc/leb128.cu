// LEB128 segmented payload-plane sum for the device varint scan (Hopper,
// sm_90a).
//
// Replaces the Pallas kernel of the JAX package's tpu/pallas_kernels.py:
//   leb128_segment_sum_kernel  <- leb128_segment_sum / _leb_segsum_kernel
// and computes out[v, p] = sum(planes[i, p] for i with seg_ids[i] == v),
// dropping ids outside [0, V) (the -1 padding).
//
// Contract (pallas_kernels.py:196-198): the planes are integers below 2^14
// and every segment's sum stays below 2^24 (tpu/decode.leb128_scan_device
// guarantees it: a varint has at most 8 bytes, and its bytes occupy
// disjoint bits of each plane). Every partial sum is then an exact float32
// integer, so the result does not depend on the order of the atomics and
// is bit-exact against the plain version (index_add_).
//
// What bounds it: bytes. Each (byte, plane) cell reads 4 bytes of plane
// and shares 4 bytes of segment id with its row; each output cell is
// written once. There is one add per input cell, so the operation bound is
// far below the bytes bound.
//
// Design. On the TPU the sum is a tiled one-hot matrix product, because
// XLA lowers the scatter to serial code there. Hopper has fast atomics in
// L2, so: one thread per (byte, plane) cell in a grid-stride loop, one
// atomicAdd into the output, which the launcher zeroes on the caller's
// stream first. The ids need not be sorted. (The scan produces sorted ids;
// a warp-segmented reduction that exploits that is later work.)
//
// Plain C interface for ctypes: every pointer and the stream are void*;
// the launcher returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void leb128_segment_sum_kernel(const float* __restrict__ planes,
                                          const int32_t* __restrict__ seg_ids,
                                          float* __restrict__ out,
                                          long long num_cells,
                                          int num_planes, int num_segments) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < num_cells; t += stride) {
        const long long i = t / num_planes;
        const int p = (int)(t - i * num_planes);
        const int32_t s = __ldg(seg_ids + i);
        if (s < 0 || s >= num_segments) continue;
        atomicAdd(out + (long long)s * num_planes + p, __ldg(planes + t));
    }
}

extern "C" {

int leb128_segment_sum_launch(const void* planes, const void* seg_ids,
                              void* out, long long num_bytes, int num_planes,
                              int num_segments, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)num_segments * num_planes * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const long long cells = num_bytes * num_planes;
    if (cells == 0) return (int)cudaGetLastError();
    const int threads = 256;
    long long blocks = (cells + threads - 1) / threads;
    const long long max_blocks = 132LL * 32;  // 32 blocks per SM, then stride
    if (blocks > max_blocks) blocks = max_blocks;
    leb128_segment_sum_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)planes, (const int32_t*)seg_ids, (float*)out, cells,
        num_planes, num_segments);
    return (int)cudaGetLastError();
}

}  // extern "C"
