// Bloom filter build and query for batched sync (Hopper, sm_90a).
//
// Replaces the Pallas kernels of the JAX package's tpu/pallas_kernels.py:
//   bloom_build_packed_kernel, bloom_build_split_kernel
//       <- bloom_build / _bloom_build_kernel (pallas_kernels.py:258)
//   bloom_query_kernel <- bloom_query / _bloom_query_kernel (:113)
// and computes bit for bit what tpu/sync_batch.build_filters / query_filters
// compute: 7 triple-hash probes per entry (x = (x + y) % m; y = (y + z) % m
// in uint32, reference backend/sync.js:88), bit p % 32 of word p / 32.
//
// What bounds them. Bytes: 12 bytes of hash per live entry or candidate
// and 4 per filter word, against a few dozen integer operations. At the
// sync farm's main-path shapes (build B 4,096 x E 64 x W 20, query
// B 4,096 x C 64 x W 4) that is ~3 MB, ~1 us at 3.35 TB/s, under what one
// launch costs on this card: there the launch floor and the chain of
// dependent memory round trips inside one wave of blocks bound them, so
// the design starts every load of a block at once, behind one barrier,
// and keeps one item per thread (with several items a thread, their
// serial probes and atomics outlast the arithmetic they save). When a
// fresh peer first syncs documents with long histories (B 2 filters of
// 10,000 entries in the sync farm's 16,384 bucket), one block per filter
// would keep 2 of the 132 SMs busy, so the build splits a filter across
// a cluster of blocks and the query across runs of candidates.
//
// Probes. m is the filter's modulo read as uint32, clamped to 1. For
// m <= 2^31, x, y < m keeps x + y below 2^32, so each of the 12 recurrence
// steps is one conditional subtraction; for m > 2^31 the reference's
// uint32 add wraps before its modulo, so that branch keeps the wrapped sum
// and a true %. The branch is uniform per filter. The three seed
// reductions: the split build, whose threads take several entries each,
// derives once per block the 64-bit reciprocal of Lemire's fast remainder,
// M = (2^64 - 1) / m + 1, and a % m = umulhi64(M * a mod 2^64, m), exact
// for every 32-bit a and m >= 1 (m = 1 gives M = 0 and the answer 0). The
// packed build and the query, one item per thread, use the hardware %
// (its reciprocal shared by the three): there the 64-bit division would
// sit between the count's arrival and the block barrier, and it costs
// more than the remainders it saves (~8 % at the main-path shapes on an
// H100 80GB HBM3).
//
// build, packed (E <= 256 and the block's rows fit in shared memory): a
// block of 256 threads holds consecutive filters, one segment of
// seg_len = max(32, next power of two >= E) threads per filter, one thread
// per entry. Before one barrier the block stages its xyz slab (contiguous:
// 16-byte loads where aligned), one thread per filter reads its count and
// derives its modulo, and the rows are zeroed in shared memory; after it
// each thread ORs its 7 probes into its filter's row with shared-memory
// atomics; after a second barrier the block writes its rows, which are
// contiguous in `words` too, coalesced.
// build, split (otherwise): one filter per cluster of k blocks of up to 256
// threads, each thread taking groups of 4 entries (three 16-byte loads
// where aligned). Block r takes the r-th k-th of the groups into its own
// row; after cluster.sync() block r ORs the r-th k-th of the row's words
// across the k rows through distributed shared memory (reads, not atomics
// into one block's row, which would all serialise on that block's SM) and
// writes them out; a second cluster.sync() keeps every row alive until the
// reads are done. OR is order-free, so the row is exact with no memset and
// no second launch. k = min(8, ceil(132 / B), ceil(groups / 256)): enough
// blocks to cover the SMs when B is small, a full block's worth of groups
// each, the portable cluster size at most; k = 1 (B >= 132, or
// E <= 1,024) is a plain launch.
// A build probe whose word index is >= num_words is dropped, as the one-hot
// versions drop it.
//
// query: segments as in the packed build, one thread per candidate, when
// C <= 256; else one block per run of 256 candidates of a filter. Before
// one barrier the block stages its candidates (contiguous), one thread per
// segment reads count and modulo, and, when the block's rows
// take at most one 16-byte load a thread, the rows are staged too (else
// they are read through L1: staging a 12.5 KB row in every block costs
// more than 7 cached reads a candidate). The candidates are read before
// the count is known, so their loads overlap its round trip; an empty
// filter answers 0. Word index clamped to num_words - 1
// (pallas_kernels.py:92); one byte out per thread, coalesced.
//
// Plain C interface for ctypes: every pointer and the stream are void*;
// each launcher returns the launch's cudaError_t so the caller can raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NUM_PROBES 7
#define BITS_PER_ENTRY 10
#define BLOCK 256            // threads per block, every kernel
#define MIN_SEG 32           // a segment is at least a warp...
#define MAX_SEGS (BLOCK / MIN_SEG)  // ...so a block holds at most 8
#define MAX_CLUSTER 8        // the portable cluster size
#define NO_OPT_IN (40 * 1024)  // dynamic shared memory above this opts in
                                // (48 KB less room for static arrays)

typedef unsigned long long u64;

struct FastMod {
    u64 M;       // (2^64 - 1) / m + 1 (0 for m = 1), when FAST; else 0
    uint32_t m;  // the modulo read as uint32, at least 1
};

template <bool FAST>
__device__ __forceinline__ FastMod fast_mod_of(uint32_t modulo) {
    const uint32_t m = modulo > 0u ? modulo : 1u;
    if constexpr (FAST) {
        return {~0ull / m + 1ull, m};
    } else {
        return {0ull, m};
    }
}

// a % m: Lemire's fast remainder when FAST, else the hardware sequence
template <bool FAST>
__device__ __forceinline__ uint32_t seed_mod(uint32_t a, const FastMod& f) {
    if constexpr (FAST) {
        return (uint32_t)__umul64hi(f.M * a, (u64)f.m);
    } else {
        return a % f.m;
    }
}

template <bool FAST>
__device__ __forceinline__ void probes(uint32_t h0, uint32_t h1, uint32_t h2,
                                       const FastMod& f, uint32_t* p) {
    const uint32_t m = f.m;
    uint32_t x = seed_mod<FAST>(h0, f), y = seed_mod<FAST>(h1, f);
    const uint32_t z = seed_mod<FAST>(h2, f);
    p[0] = x;
    if (m <= 0x80000000u) {
#pragma unroll
        for (int i = 1; i < NUM_PROBES; ++i) {
            x += y;  // x, y < m <= 2^31: no wrap
            x = x >= m ? x - m : x;
            y += z;
            y = y >= m ? y - m : y;
            p[i] = x;
        }
    } else {
#pragma unroll
        for (int i = 1; i < NUM_PROBES; ++i) {
            x = (x + y) % m;  // uint32 add wraps before the modulo, as in JAX
            y = (y + z) % m;
            p[i] = x;
        }
    }
}

__device__ __forceinline__ uint32_t filter_modulo(int32_t count) {
    // 8 * ceil(count * 10 / 8) (sync.js:45) in int64 as the plain version
    // does; the arithmetic shift floors, so a negative count rounds as
    // JAX's ceil does
    return (uint32_t)(8ll * (((long long)count * BITS_PER_ENTRY + 7) >> 3));
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Copies `n` contiguous words into shared memory with the whole block, as
// 16-byte loads when both ends are aligned (then the tail word by word),
// else word by word. Every load is independent of the others.
__device__ __forceinline__ void stage(uint32_t* __restrict__ dst,
                                      const uint32_t* __restrict__ src,
                                      int n) {
    int done = 0;
    if (aligned16(src) && aligned16(dst)) {
        const int n4 = n >> 2;
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        uint4* d4 = reinterpret_cast<uint4*>(dst);
        for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = __ldg(s4 + i);
        done = n4 << 2;
    }
    for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Items [i0, i0 + 4) of a slab of `n` 3-word items into h[12]: three 16-byte
// loads when the slab is aligned (i0 is a multiple of 4, so item i0 starts
// 48 * i0 / 4 bytes in) and the group is whole, else word by word with the
// items at or past n left 0.
__device__ __forceinline__ void load4(const uint32_t* __restrict__ slab,
                                      int i0, int n, bool vec, uint32_t* h) {
    if (vec && i0 + 4 <= n) {
        const uint4* v = reinterpret_cast<const uint4*>(slab + 3 * i0);
        const uint4 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2);
        h[0] = a.x; h[1] = a.y; h[2] = a.z; h[3] = a.w;
        h[4] = b.x; h[5] = b.y; h[6] = b.z; h[7] = b.w;
        h[8] = c.x; h[9] = c.y; h[10] = c.z; h[11] = c.w;
    } else {
#pragma unroll
        for (int k = 0; k < 12; ++k)
            h[k] = i0 + k / 3 < n ? __ldg(slab + 3 * i0 + k) : 0u;
    }
}

// ORs the in-range probes of one entry into row.
template <bool FAST>
__device__ __forceinline__ void or_probes(uint32_t h0, uint32_t h1,
                                          uint32_t h2, const FastMod& f,
                                          uint32_t* row, int num_words) {
    uint32_t p[NUM_PROBES];
    probes<FAST>(h0, h1, h2, f, p);
#pragma unroll
    for (int i = 0; i < NUM_PROBES; ++i) {
        const uint32_t w = p[i] >> 5;
        if (w < (uint32_t)num_words) atomicOr(&row[w], 1u << (p[i] & 31u));
    }
}

// Packed build (see the note at the top).
__global__ void __launch_bounds__(BLOCK)
bloom_build_packed_kernel(const uint32_t* __restrict__ xyz,
                          const int32_t* __restrict__ counts,
                          uint32_t* __restrict__ words,
                          int32_t* __restrict__ modulo_out, int batch,
                          int num_entries, int num_words, int seg_shift) {
    extern __shared__ uint32_t rows[];
    __shared__ __align__(16) uint32_t s_slab[BLOCK * 3];
    __shared__ FastMod s_f[MAX_SEGS];
    __shared__ int s_n[MAX_SEGS];
    const int segs = BLOCK >> seg_shift;
    const int b0 = blockIdx.x * segs;
    const int nf = min(segs, batch - b0);
    const int t = threadIdx.x;
    stage(s_slab, xyz + (size_t)b0 * num_entries * 3, nf * num_entries * 3);
    if (t < nf) {
        const int32_t count = counts[b0 + t];
        const uint32_t modulo = filter_modulo(count);
        s_f[t] = fast_mod_of<false>(modulo);
        s_n[t] = min(count, num_entries);
        modulo_out[b0 + t] = (int32_t)modulo;
    }
    for (int w = t; w < nf * num_words; w += BLOCK) rows[w] = 0u;
    __syncthreads();
    const int seg = t >> seg_shift, e = t & ((1 << seg_shift) - 1);
    if (seg < nf && e < s_n[seg]) {
        const uint32_t* h = s_slab + 3 * (seg * num_entries + e);
        or_probes<false>(h[0], h[1], h[2], s_f[seg], rows + seg * num_words,
                  num_words);
    }
    __syncthreads();
    uint32_t* out = words + (size_t)b0 * num_words;
    for (int w = t; w < nf * num_words; w += BLOCK) out[w] = rows[w];
}

// Split build, one filter per cluster of k blocks (see the note).
template <bool CLUSTER>
__global__ void __launch_bounds__(BLOCK)
bloom_build_split_kernel(const uint32_t* __restrict__ xyz,
                         const int32_t* __restrict__ counts,
                         uint32_t* __restrict__ words,
                         int32_t* __restrict__ modulo_out, int num_entries,
                         int num_words, int k) {
    extern __shared__ uint32_t row[];
    __shared__ FastMod s_f;
    __shared__ int s_n;
    const int b = blockIdx.x / k, r = blockIdx.x % k;  // r = rank in cluster
    if (threadIdx.x == 0) {
        const int32_t count = counts[b];
        const uint32_t modulo = filter_modulo(count);
        s_f = fast_mod_of<true>(modulo);
        s_n = min(count, num_entries);
        if (r == 0) modulo_out[b] = (int32_t)modulo;
    }
    for (int w = threadIdx.x; w < num_words; w += blockDim.x) row[w] = 0u;
    __syncthreads();
    const FastMod f = s_f;
    const int n = s_n;
    const int groups = n > 0 ? (n + 3) / 4 : 0;
    const int per = (groups + k - 1) / k;
    const int g_end = min(groups, (r + 1) * per);
    const uint32_t* slab = xyz + (size_t)b * num_entries * 3;
    const bool vec = aligned16(slab);
    for (int g = r * per + threadIdx.x; g < g_end; g += blockDim.x) {
        uint32_t h[12];
        load4(slab, 4 * g, num_entries, vec, h);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (4 * g + j < n)
                or_probes<true>(h[3 * j], h[3 * j + 1], h[3 * j + 2], f, row,
                          num_words);
    }
    uint32_t* out = words + (size_t)b * num_words;
    if constexpr (CLUSTER) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        const int slice = (num_words + k - 1) / k;
        const int w_end = min(num_words, (r + 1) * slice);
        for (int w = r * slice + threadIdx.x; w < w_end; w += blockDim.x) {
            uint32_t v = 0u;
#pragma unroll
            for (int q = 0; q < MAX_CLUSTER; ++q)
                if (q < k) v |= cluster.map_shared_rank(row, q)[w];
            out[w] = v;
        }
        cluster.sync();
    } else {
        __syncthreads();
        for (int w = threadIdx.x; w < num_words; w += blockDim.x) out[w] = row[w];
    }
}

// Query (see the note). Block (i, j) takes run j of filters
// [i * segs, i * segs + segs); there is one run when C <= 256, so a block
// packs whole filters, else segs = 1. A block's candidates, and its
// filters' rows, are contiguous.
template <bool STAGED>
__global__ void __launch_bounds__(BLOCK)
bloom_query_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ modulo,
                   const int32_t* __restrict__ counts,
                   const uint32_t* __restrict__ query,
                   uint8_t* __restrict__ out, int batch, int num_cand,
                   int num_words, int seg_shift) {
    extern __shared__ uint32_t rows[];
    __shared__ __align__(16) uint32_t s_slab[BLOCK * 3];
    __shared__ FastMod s_f[MAX_SEGS];
    __shared__ int s_live[MAX_SEGS];
    const int seg_len = 1 << seg_shift, segs = BLOCK >> seg_shift;
    const int b0 = blockIdx.x * segs;
    const int nf = min(segs, batch - b0);
    const int c0 = blockIdx.y * seg_len;  // 0 unless a filter spans runs
    const int c_end = min(num_cand, c0 + seg_len);
    const int t = threadIdx.x;
    // the block's candidates: filters b0.. b0+nf-1, candidates [c0, c_end)
    // of each; contiguous because c0 > 0 only when nf = 1
    const size_t first = (size_t)b0 * num_cand + c0;
    const int span = (nf - 1) * num_cand + (c_end - c0);
    stage(s_slab, query + 3 * first, 3 * span);
    if (t < nf) {
        s_live[t] = __ldg(counts + b0 + t) > 0;
        s_f[t] = fast_mod_of<false>((uint32_t)__ldg(modulo + b0 + t));
    }
    if constexpr (STAGED)
        stage(rows, words + (size_t)b0 * num_words, nf * num_words);
    __syncthreads();
    const int seg = t >> seg_shift;
    const int c = c0 + (t & (seg_len - 1));
    if (seg >= nf || c >= c_end) return;
    const int b = b0 + seg;
    const int at = seg * num_cand + (c - c0);  // in the block's slab
    uint32_t all = 0u;
    if (s_live[seg]) {
        const uint32_t* h = s_slab + 3 * at;
        uint32_t p[NUM_PROBES];
        probes<false>(h[0], h[1], h[2], s_f[seg], p);
        const uint32_t last = (uint32_t)(num_words - 1);
        const uint32_t* row = words + (size_t)b * num_words;
        const uint32_t* srow = rows + seg * num_words;
        all = 1u;
#pragma unroll
        for (int i = 0; i < NUM_PROBES; ++i) {
            uint32_t w = p[i] >> 5;
            w = w < last ? w : last;
            uint32_t word;
            if constexpr (STAGED) word = srow[w]; else word = __ldg(row + w);
            all &= (word >> (p[i] & 31u)) & 1u;
        }
    }
    out[first + at] = (uint8_t)all;
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= NO_OPT_IN) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// log2 of the threads per segment for n items: the next power of two
// >= n, at least a warp; -1 when n exceeds a block.
static int seg_shift_for(int n) {
    if (n > BLOCK) return -1;
    int shift = 5;  // MIN_SEG
    while ((1 << shift) < n) ++shift;
    return shift;
}

extern "C" {

int bloom_smem_limit(int device) {
    int bytes = 0;
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    return bytes;
}

int bloom_sm_count(int device) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    return sms;
}

// The build's launch plan (see the note): 0 = packed; else the split
// build's cluster size k (1 = one block per filter, no cluster). The
// wrapper passes the device's shared-memory opt-in limit and SM count.
int bloom_build_plan(int batch, int num_entries, int num_words,
                     int smem_limit, int num_sms) {
    const size_t row_bytes = (size_t)num_words * sizeof(uint32_t);
    const int seg_shift = seg_shift_for(num_entries);
    const int segs = seg_shift >= 0 ? BLOCK >> seg_shift : 0;
    if (segs && segs * row_bytes + BLOCK * 12 + 256 <= (size_t)smem_limit)
        return 0;
    const int groups = (num_entries + 3) / 4;
    int k = (num_sms + batch - 1) / batch;
    k = min(k, (groups + BLOCK - 1) / BLOCK);
    return max(1, min(k, MAX_CLUSTER));
}

// Builds `batch` filters by the plan above. The wrapper has checked that
// one row fits the shared-memory limit.
int bloom_build_launch(const void* xyz, const void* counts, void* words,
                       void* modulo, int batch, int num_entries,
                       int num_words, int smem_limit, int num_sms,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* x = (const uint32_t*)xyz;
    const int32_t* c = (const int32_t*)counts;
    uint32_t* w = (uint32_t*)words;
    int32_t* m = (int32_t*)modulo;
    const size_t row_bytes = (size_t)num_words * sizeof(uint32_t);
    const int k = bloom_build_plan(batch, num_entries, num_words, smem_limit,
                                   num_sms);
    cudaError_t err;
    if (k == 0) {
        const int seg_shift = seg_shift_for(num_entries);
        const int segs = BLOCK >> seg_shift;
        const size_t smem = segs * row_bytes;
        if ((err = allow_smem(bloom_build_packed_kernel, smem)) != cudaSuccess)
            return (int)err;
        bloom_build_packed_kernel<<<(batch + segs - 1) / segs, BLOCK, smem,
                                    s>>>(x, c, w, m, batch, num_entries,
                                         num_words, seg_shift);
        return (int)cudaGetLastError();
    }
    const int groups = (num_entries + 3) / 4;
    const int per = (groups + k - 1) / k;
    const int threads = min(BLOCK, max(32, (per + 31) / 32 * 32));
    if (k == 1) {
        if ((err = allow_smem(bloom_build_split_kernel<false>, row_bytes)) !=
            cudaSuccess)
            return (int)err;
        bloom_build_split_kernel<false><<<batch, threads, row_bytes, s>>>(
            x, c, w, m, num_entries, num_words, 1);
        return (int)cudaGetLastError();
    }
    if ((err = allow_smem(bloom_build_split_kernel<true>, row_bytes)) !=
        cudaSuccess)
        return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)batch * k);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = row_bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, bloom_build_split_kernel<true>, x, c, w, m,
                             num_entries, num_words, k);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Tests C candidates against each of `batch` filters: blocks of whole
// filters in segments of 2^seg_shift threads when C <= 256, else one block
// per run of 256 candidates of a filter; rows staged when the block's rows
// are at most one 16-byte load a thread.
int bloom_query_launch(const void* words, const void* modulo,
                       const void* counts, const void* query, void* out,
                       int batch, int num_cand, int num_words,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int seg_shift = seg_shift_for(num_cand);
    const unsigned runs =
        seg_shift >= 0 ? 1u : (unsigned)((num_cand + BLOCK - 1) / BLOCK);
    if (seg_shift < 0) seg_shift = 8;  // log2(BLOCK)
    const int segs = BLOCK >> seg_shift;
    const dim3 grid((unsigned)((batch + segs - 1) / segs), runs);
    const long long row_words = (long long)segs * num_words;
    const uint32_t* wd = (const uint32_t*)words;
    const int32_t* md = (const int32_t*)modulo;
    const int32_t* ct = (const int32_t*)counts;
    const uint32_t* q = (const uint32_t*)query;
    uint8_t* o = (uint8_t*)out;
    if (row_words <= 4 * BLOCK) {
        bloom_query_kernel<true><<<grid, BLOCK,
                                   (size_t)row_words * sizeof(uint32_t), s>>>(
            wd, md, ct, q, o, batch, num_cand, num_words, seg_shift);
    } else {
        bloom_query_kernel<false><<<grid, BLOCK, 0, s>>>(
            wd, md, ct, q, o, batch, num_cand, num_words, seg_shift);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
