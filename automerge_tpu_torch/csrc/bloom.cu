// Bloom filter build and query for batched sync (Hopper, sm_90a).
//
// Replaces the Pallas kernels of the JAX package's tpu/pallas_kernels.py:
//   bloom_build_kernel  <- bloom_build / _bloom_build_kernel
//   bloom_query_kernel  <- bloom_query / _bloom_query_kernel
// and computes bit for bit what tpu/sync_batch.build_filters / query_filters
// compute: 7 triple-hash probes per entry (x = (x + y) % m; y = (y + z) % m
// in uint32, reference backend/sync.js:88), bit p % 32 of word p / 32.
//
// What bounds them: bytes. Each entry or candidate is 12 bytes of hash in
// and a few dozen integer operations; a filter row is 4 bytes a word. At
// the sync farm's shapes (thousands of filters of tens of words) the work
// is a few megabytes, so the launch itself is most of the time.
//
// Design. The TPU kernels gather words with a one-hot matrix product and
// OR-reduce with a one-hot contraction because the TPU has no cheap scatter
// or gather. Hopper has both, so:
//   build: one block per filter. The row lives in shared memory; each
//          thread computes the probes of its entries and atomicOr's the bits
//          into shared memory; after a barrier the block writes the row out
//          coalesced. A probe whose word index is >= num_words is dropped,
//          as the one-hot versions drop it.
//   query: one thread per (filter, candidate): 7 reads of the filter row
//          through the read-only cache, word index clamped to num_words - 1
//          (pallas_kernels.py:92), AND of the probed bits; an empty filter
//          (count 0) answers false.
//
// Plain C interface for ctypes: every pointer and the stream are void*;
// each launcher returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_PROBES 7
#define BITS_PER_ENTRY 10

__device__ __forceinline__ uint32_t filter_modulo(int32_t count) {
    // 8 * ceil(count * 10 / 8): the filter's bit size (sync.js:45)
    return 8u * (uint32_t)((count * BITS_PER_ENTRY + 7) / 8);
}

__device__ __forceinline__ void probes(const uint32_t* h, uint32_t m,
                                       uint32_t* out) {
    uint32_t x = h[0] % m, y = h[1] % m, z = h[2] % m;
    out[0] = x;
#pragma unroll
    for (int i = 1; i < NUM_PROBES; ++i) {
        x = (x + y) % m;  // uint32 add wraps before the modulo, as in JAX
        y = (y + z) % m;
        out[i] = x;
    }
}

__global__ void bloom_build_kernel(const uint32_t* __restrict__ xyz,
                                   const int32_t* __restrict__ counts,
                                   uint32_t* __restrict__ words,
                                   int32_t* __restrict__ modulo_out,
                                   int num_entries, int num_words) {
    extern __shared__ uint32_t row[];
    const int b = blockIdx.x;
    for (int w = threadIdx.x; w < num_words; w += blockDim.x) row[w] = 0u;
    const int32_t count = counts[b];
    const uint32_t modulo = filter_modulo(count);
    if (threadIdx.x == 0) modulo_out[b] = (int32_t)modulo;
    __syncthreads();
    const uint32_t m = modulo > 0u ? modulo : 1u;
    const int n = count < num_entries ? count : num_entries;
    const uint32_t* base = xyz + (size_t)b * num_entries * 3;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        uint32_t h[3] = {base[3 * e], base[3 * e + 1], base[3 * e + 2]};
        uint32_t p[NUM_PROBES];
        probes(h, m, p);
#pragma unroll
        for (int i = 0; i < NUM_PROBES; ++i) {
            const uint32_t w = p[i] >> 5;
            if (w < (uint32_t)num_words) atomicOr(&row[w], 1u << (p[i] & 31u));
        }
    }
    __syncthreads();
    uint32_t* out = words + (size_t)b * num_words;
    for (int w = threadIdx.x; w < num_words; w += blockDim.x) out[w] = row[w];
}

__global__ void bloom_query_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ modulo,
                                   const int32_t* __restrict__ counts,
                                   const uint32_t* __restrict__ query,
                                   uint8_t* __restrict__ out,
                                   int batch, int num_cand, int num_words) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)batch * num_cand) return;
    const int b = (int)(t / num_cand);
    if (counts[b] <= 0) {
        out[t] = 0;
        return;
    }
    const uint32_t mod = (uint32_t)modulo[b];
    const uint32_t m = mod > 0u ? mod : 1u;
    const uint32_t h[3] = {__ldg(query + 3 * t), __ldg(query + 3 * t + 1),
                           __ldg(query + 3 * t + 2)};
    uint32_t p[NUM_PROBES];
    probes(h, m, p);
    const uint32_t* row = words + (size_t)b * num_words;
    const uint32_t last = (uint32_t)(num_words - 1);
    uint32_t all = 1u;
#pragma unroll
    for (int i = 0; i < NUM_PROBES; ++i) {
        uint32_t w = p[i] >> 5;
        w = w < last ? w : last;
        all &= (__ldg(row + w) >> (p[i] & 31u)) & 1u;
    }
    out[t] = (uint8_t)all;
}

extern "C" {

int bloom_build_smem_limit(int device) {
    int bytes = 0;
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    return bytes;
}

int bloom_build_launch(const void* xyz, const void* counts, void* words,
                       void* modulo, int batch, int num_entries,
                       int num_words, int threads, void* stream) {
    const size_t smem = (size_t)num_words * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            bloom_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    bloom_build_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)xyz, (const int32_t*)counts, (uint32_t*)words,
        (int32_t*)modulo, num_entries, num_words);
    return (int)cudaGetLastError();
}

int bloom_query_launch(const void* words, const void* modulo,
                       const void* counts, const void* query, void* out,
                       int batch, int num_cand, int num_words,
                       void* stream) {
    const long long total = (long long)batch * num_cand;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    bloom_query_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int32_t*)modulo,
        (const int32_t*)counts, (const uint32_t*)query, (uint8_t*)out,
        batch, num_cand, num_words);
    return (int)cudaGetLastError();
}

}  // extern "C"
