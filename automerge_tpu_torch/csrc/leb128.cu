// LEB128 segmented payload-plane sum for the device varint scan (Hopper,
// sm_90a).
//
// Replaces the Pallas kernel of the JAX package's tpu/pallas_kernels.py:
//   leb128_segment_sum  <- leb128_segment_sum / _leb_segsum_kernel
// and computes out[v, p] = sum(planes[i, p] for i with seg_ids[i] == v),
// dropping ids outside [0, V) (the -1 padding); a row no id names reads 0.
//
// Contract (pallas_kernels.py:196-198): the planes are integers below 2^14
// and every segment's sum stays below 2^24 (tpu/decode.leb128_scan_device
// guarantees it: a varint has at most 8 bytes, and its bytes occupy
// disjoint bits of each plane). Every partial sum is then an exact float32
// integer, so the result does not depend on the order of the adds and is
// bit-exact against the plain version (index_add_).
//
// What bounds it: bytes. Each row of planes and each id must be read once
// and each output row written once; there is one add per input cell, so
// the operation bound is far below the bytes bound.
//
// Design. The scan's ids are seg = cumsum(is_end) - is_end: non-decreasing
// and dense, each id one contiguous run (about 1.07 bytes per varint on
// the driven stream). So the common case needs no memset and no atomics:
//
// 1. leb128_sorted_pass: one thread per row, plus one thread for a virtual
//    row N whose id is V. A thread reads its id once and takes its
//    neighbours' ids by warp shuffle (lane 0 and lane 31 load the one
//    across the warp edge). Ids are clamped: < 0 reads -1 and >= V reads
//    V, so the dropped rows form one run each. A row whose clamped id
//    differs from its predecessor's heads a run; the head of an in-range
//    run sums the run forward, in order, and stores it once with a plain
//    (16-byte, for P == 4) store. Every head also zero-fills the ids
//    skipped since the previous in-range id, so the heads together tile
//    [0, V) exactly once: [0, first) by the first head, (last, V) by the
//    head of the >= V run or by the virtual row N. Index math is 32-bit
//    wherever the offsets fit, and there is no division.
// 2. Unsorted ids are caught on the device. A block of the sorted pass
//    votes before it stores anything: if any of its rows sees a
//    descending pair of clamped ids, one thread writes `gen` to a flag
//    word and the block returns, since its work would be redone (so
//    shuffled ids cost the sorted pass one read of the ids and planes,
//    and no bogus gap fills). Two guarded kernels are always enqueued
//    behind the sorted pass and return at once unless the flag holds
//    `gen`: leb128_general_zero zeroes the output, then
//    leb128_general_add redoes it with one row per thread and one float4
//    atomicAdd per row (sm_90 has them from CUDA 12.1; on the H100 they
//    beat four scalar atomics per row from one thread, each of which is a
//    transaction of its own).
//
// Why a generation and not a reset flag: the wrapper allocates the flag
// word per call on the caller's stream (torch.empty, so a CUDA graph of
// many calls stays valid) but does not clear it, which would cost a fill
// launch per call. Each call passes a fresh `gen` drawn from the int32 bit
// patterns of quiet NaNs (no id, sum or plane of the scan has them), and
// only a word equal to `gen` counts as set. A stale word equal to `gen`
// (a graph replayed after its inputs changed, or 2^22 calls later) only
// sends a sorted call down the general path, which is right for any ids;
// a call with a descending pair always writes its own `gen`. So the
// result never depends on what the word held before.
//
// A long run (or a long gap of absent ids) is summed (or zeroed) by its
// one head thread: correct, and unbalanced; the scan's runs are at most 8
// rows and it leaves no gaps. (A locally sorted block of unsorted ids may
// likewise zero a long gap that the general pass then redoes.)
//
// Plain C interface for ctypes: every pointer and the stream are void*;
// the launcher returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// The general pass: grid-stride loops on one 1024-thread block per SM.
// Few, wide blocks make its two launches cheaper when the flag is clear
// than 1,056 blocks of 256 did on the H100, and fill the card as well
// when it is set.
constexpr int kGeneralThreads = 1024;
constexpr long long kGeneralBlocks = 132;

__device__ __forceinline__ int clamp_id(int32_t s, int num_segments) {
    return s < 0 ? -1 : (s >= num_segments ? num_segments : s);
}

// The clamped id of row j; rows at or past N read as the virtual id V.
template <typename Idx>
__device__ __forceinline__ int id_at(const int32_t* __restrict__ seg_ids,
                                     Idx j, Idx n, int num_segments) {
    return j < n ? clamp_id(__ldg(seg_ids + j), num_segments)
                 : num_segments;
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}

// kVec4: P == 4 and both planes and out 16-byte aligned.
template <typename Idx, bool kVec4>
__global__ void __launch_bounds__(kThreads) leb128_sorted_pass(
        const float* __restrict__ planes, const int32_t* __restrict__ seg_ids,
        float* __restrict__ out, int* __restrict__ flag, int gen, Idx n,
        int num_planes, int num_segments) {
    const Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int c = id_at(seg_ids, i, n, num_segments);
    float4 mine = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kVec4 && i < n) mine = __ldg(reinterpret_cast<const float4*>(planes) + i);
    int prev = __shfl_up_sync(kFull, c, 1);
    if (lane == 0) prev = i == 0 ? -1 : id_at(seg_ids, i - 1, n, num_segments);
    int next = __shfl_down_sync(kFull, c, 1);
    if (lane == 31) next = id_at(seg_ids, i + 1, n, num_segments);
    // The block votes: a descending pair anywhere in it means the general
    // pass will redo every row, so the block sets the flag with one store
    // and does nothing more (in shuffled ids no head zero-fills a gap that
    // is not one). Blocks do not read the flag here: ~5,600 blocks reading
    // one word serialise on its L2 slice, and on shuffled ids that cost
    // more than the work it would skip.
    if (__syncthreads_or(i <= n && prev > c)) {
        if (threadIdx.x == 0) *flag = gen;
        return;
    }
    if (i > n) return;
    if (c == prev || c < 0) return;  // not a head, or the dropped -1 run
    // head of the run of id c (c == V: the dropped >= V run or row N):
    // zero the ids skipped since the previous in-range id
    const Idx lo = prev < 0 ? 0 : (Idx)prev + 1;
    if (kVec4) {
        for (Idx r = lo; r < (Idx)c; ++r)
            reinterpret_cast<float4*>(out)[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
        for (Idx k = lo * num_planes; k < (Idx)c * num_planes; ++k) out[k] = 0.f;
    }
    if (c == num_segments) return;
    Idx j = i + 1;  // sum the run forward, in order
    if (kVec4) {
        const float4* in4 = reinterpret_cast<const float4*>(planes);
        for (int id = next; id == c; id = id_at(seg_ids, ++j, n, num_segments))
            add4(mine, __ldg(in4 + j));
        reinterpret_cast<float4*>(out)[c] = mine;
    } else {
        for (int id = next; id == c; id = id_at(seg_ids, ++j, n, num_segments)) {
        }
        for (int p = 0; p < num_planes; ++p) {
            float acc = 0.f;
            for (Idx r = i; r < j; ++r) acc += __ldg(planes + r * num_planes + p);
            out[(Idx)c * num_planes + p] = acc;
        }
    }
}

// The general pass, step 1: zero the output when the flag holds `gen`.
template <typename Idx, bool kVec4>
__global__ void __launch_bounds__(kGeneralThreads) leb128_general_zero(
        float* __restrict__ out, const int* __restrict__ flag, int gen,
        Idx num_segments, int num_planes) {
    if (*flag != gen) return;
    const Idx stride = (Idx)gridDim.x * kGeneralThreads;
    const Idx start = (Idx)blockIdx.x * kGeneralThreads + threadIdx.x;
    if (kVec4) {
        float4* out4 = reinterpret_cast<float4*>(out);
        for (Idx r = start; r < num_segments; r += stride)
            out4[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
        const Idx cells = num_segments * num_planes;
        for (Idx k = start; k < cells; k += stride) out[k] = 0.f;
    }
}

// The general pass, step 2: one row per thread, atomics into the zeroed
// output, for any order of ids.
template <typename Idx, bool kVec4>
__global__ void __launch_bounds__(kGeneralThreads) leb128_general_add(
        const float* __restrict__ planes, const int32_t* __restrict__ seg_ids,
        float* __restrict__ out, const int* __restrict__ flag, int gen, Idx n,
        int num_planes, int num_segments) {
    if (*flag != gen) return;
    const Idx stride = (Idx)gridDim.x * kGeneralThreads;
    for (Idx i = (Idx)blockIdx.x * kGeneralThreads + threadIdx.x; i < n; i += stride) {
        const int32_t s = __ldg(seg_ids + i);
        if (s < 0 || s >= num_segments) continue;
        if (kVec4) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(planes) + i);
            atomicAdd(reinterpret_cast<float4*>(out) + s, x);
        } else {
            for (int p = 0; p < num_planes; ++p)
                atomicAdd(out + (Idx)s * num_planes + p,
                          __ldg(planes + i * num_planes + p));
        }
    }
}

long long general_blocks(long long work) {
    const long long blocks = (work + kGeneralThreads - 1) / kGeneralThreads;
    return blocks < 1 ? 1 : (blocks > kGeneralBlocks ? kGeneralBlocks : blocks);
}

template <typename Idx, bool kVec4>
int launch_all(const float* planes, const int32_t* seg_ids, float* out,
               int* flag, int gen, long long n, int num_planes,
               int num_segments, cudaStream_t s) {
    const long long sorted_blocks = (n + 1 + kThreads - 1) / kThreads;
    leb128_sorted_pass<Idx, kVec4><<<(unsigned)sorted_blocks, kThreads, 0, s>>>(
        planes, seg_ids, out, flag, gen, (Idx)n, num_planes, num_segments);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n < 2) return (int)err;  // < 2 rows: sorted
    const long long cells = kVec4 ? (long long)num_segments
                                  : (long long)num_segments * num_planes;
    leb128_general_zero<Idx, kVec4><<<(unsigned)general_blocks(cells),
                                      kGeneralThreads, 0, s>>>(out, flag, gen,
                                              (Idx)num_segments, num_planes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    leb128_general_add<Idx, kVec4><<<(unsigned)general_blocks(n),
                                     kGeneralThreads, 0, s>>>(planes, seg_ids, out, flag, gen,
                                          (Idx)n, num_planes, num_segments);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// planes [num_bytes, num_planes] f32, seg_ids [num_bytes] int32 -> out
// [num_segments, num_planes] f32 (uninitialised on entry); flag: one int32
// word of scratch; gen: this call's generation (see the note above).
int leb128_segment_sum_launch(const void* planes, const void* seg_ids,
                              void* out, void* flag, long long num_bytes,
                              int num_planes, int num_segments, int gen,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (num_planes <= 0 || num_segments <= 0) return (int)cudaSuccess;
    const bool vec4 = num_planes == 4 &&
                      ((uintptr_t)planes & 15) == 0 && ((uintptr_t)out & 15) == 0;
    // 32-bit offsets when every row index (one block past N) and every
    // output cell fits
    const bool small =
        (num_bytes + 1 + kThreads) * num_planes < (long long)INT_MAX &&
        (long long)num_segments * num_planes < (long long)INT_MAX;
    const float* p = (const float*)planes;
    const int32_t* ids = (const int32_t*)seg_ids;
    float* o = (float*)out;
    int* f = (int*)flag;
    if (small) {
        return vec4 ? launch_all<int, true>(p, ids, o, f, gen, num_bytes,
                                            num_planes, num_segments, s)
                    : launch_all<int, false>(p, ids, o, f, gen, num_bytes,
                                             num_planes, num_segments, s);
    }
    return vec4 ? launch_all<long long, true>(p, ids, o, f, gen, num_bytes,
                                              num_planes, num_segments, s)
                : launch_all<long long, false>(p, ids, o, f, gen, num_bytes,
                                               num_planes, num_segments, s);
}

}  // extern "C"
