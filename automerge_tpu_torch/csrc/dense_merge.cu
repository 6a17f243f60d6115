// Dense whole-state merge: each document's round of change rows merged into
// its sorted op table in place (Hopper, sm_90a).
//
// Replaces no Pallas kernel: the JAX package's merge is an XLA program
// (tpu/engine.py, engine.apply_ops, the vmapped _merge_one_doc at
// engine.py:181). The port's plain version, tpu/engine.py merge_docs plus
// six copies back into the state, makes some 92 launches over the whole
// padded [docs, capacity] table a round, whatever a document holds. This
// kernel is what batched_apply_ops runs for tensors on the card
// (tpu/merge_kernels.py); its result equals the plain version's bit for
// bit on all rows, given the padding below.
//
// Columns. State [docs, n]: key int32, op int64, action int32, value
// int64, pred int64, overwritten uint8 (torch.bool), and num_ops int32
// [docs]. Changes [docs, m]: key, op, action, value, pred as above. A row
// with key PAD_KEY is padding. Merge key: (int64(key) << 44) | op, and
// INT64_MAX for padding, as engine._merge_key computes it (the shift wraps
// as torch's does).
//
// Padding contract: state and change padding rows hold what
// make_empty_state writes (PAD_KEY, 0, SET, 0, -1, false), and a table is
// sorted by merge key with its padding after its h live rows. Then the
// plain version's rows past h + (real change rows) are padding again, and
// this kernel leaves them untouched.
//
// What bounds it: bytes. A document holding h live rows that takes r real
// change rows at first insertion point p reads rows p..h-1 once, writes
// rows p..h+r-1 once (33 B a row) and reads its m change rows (32 B a
// row). benchmark/harness/roofline.py counts every live row read and
// written (p = 0), so the rows before a round's first insert separate the
// two: in the dense-100k cell (~57 ops a round on keys uniform over 64,
// each inserted after its key's held rows) about 1.7 h/64, so the bound
// counts some 2-3 % more bytes than the kernel moves and its roofline share
// reads that much high. Operations are a few compares a row.
//
// Design: one block per document; documents are independent and a
// document's rows are contiguous in every column.
//
// 1. Shared memory takes the change rows' merge keys and hide keys
//    ((key << 44) | pred for a non-increment row with pred >= 0, else
//    INT64_MAX). The stable order of the change rows (merge key, then the
//    handed index, as argsort(stable=True) breaks the ties of a set and
//    its marker rows) and the sorted hide list come from ranks counted
//    over all m rows (m is small: 64-80 on the main path).
// 2. In the same pass, threads binary-search the old table (global
//    memory, padding read as INT64_MAX): each change row's insertion
//    point (searchsorted side="left"), each hide key's first row, and the
//    live length h (the first PAD_KEY; num_ops is not trusted for it).
//    A sorted row's output slot is its insertion point plus its rank.
// 3. Old rows before the first output slot p do not move. Hides that name
//    one of them set its overwritten flag where it lies (every row of that
//    merge key: a set and its markers share one).
// 4. Rows p..min(h + r, n) - 1 are rebuilt in place, a tile of
//    kThreads * kRowsPerThread rows at a time from the top down. Output
//    slot t takes sorted change row k-1 where that row's slot is t, else
//    old row t - k, k being the sorted rows whose slot is at or before t.
//    A tile reads all its sources into registers, passes one barrier,
//    then writes: a source lies at or below its slot, so a tile never
//    reads a row that a tile above it wrote, and the next tile's sources
//    lie below this tile's slots. A written row is overwritten if it was
//    (old rows) or its merge key is in the hide list, which covers rows
//    hidden by another row of the same round. Rows whose slot is n or
//    more are dropped, and still count in num_ops, as in the plain
//    version.
//
// Plain C interface for ctypes: every pointer and the stream are void*;
// the launcher returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int32_t kPadKey = 0x7fffffff;
constexpr int64_t kI64Max = 0x7fffffffffffffffLL;
constexpr int kOpBits = 44;
constexpr int32_t kActionInc = 1;
// shared memory a change row takes: three int64 and four int32 arrays
// (tpu/merge_kernels.py SMEM_BYTES_PER_ROW)
constexpr int kSmemPerRow = 3 * 8 + 4 * 4;

__device__ __forceinline__ int64_t shifted_key(int32_t key) {
    return (int64_t)((uint64_t)(int64_t)key << kOpBits);
}

__device__ __forceinline__ int64_t merge_key(int32_t key, int64_t op) {
    return key == kPadKey ? kI64Max : (shifted_key(key) | op);
}

// First row of [0, n) whose merge key is not below `target`.
__device__ int lower_bound_rows(const int32_t* __restrict__ key,
                                const int64_t* __restrict__ op, int n,
                                int64_t target) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (merge_key(key[mid], op[mid]) < target) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Entries of sorted `a[0, len)` at or below `t`.
__device__ __forceinline__ int count_at_or_below(const int32_t* a, int len,
                                                 int t) {
    int lo = 0, hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] <= t) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ bool in_sorted(const int64_t* a, int len,
                                          int64_t x) {
    int lo = 0, hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo < len && a[lo] == x;
}

__global__ void __launch_bounds__(kThreads) dense_merge_kernel(
        int32_t* __restrict__ s_key, int64_t* __restrict__ s_op,
        int32_t* __restrict__ s_action, int64_t* __restrict__ s_value,
        int64_t* __restrict__ s_pred, uint8_t* __restrict__ s_over,
        int32_t* __restrict__ num_ops, const int32_t* __restrict__ c_key,
        const int64_t* __restrict__ c_op,
        const int32_t* __restrict__ c_action,
        const int64_t* __restrict__ c_value,
        const int64_t* __restrict__ c_pred, int n, int m) {
    extern __shared__ int64_t smem[];
    int64_t* u_mkey = smem;          // [m] merge keys, as handed
    int64_t* u_hide = u_mkey + m;    // [m] hide keys, as handed
    int64_t* hide = u_hide + m;      // [m] hide keys, sorted
    int32_t* pos = reinterpret_cast<int32_t*>(hide + m);  // [m] as handed
    int32_t* hide_at = pos + m;      // [m] a hide key's first old row
    int32_t* src = hide_at + m;      // [m] handed index of sorted row r
    int32_t* slot = src + m;         // [m] output slot of sorted row r
    __shared__ int s_real, s_hides, s_h;

    const int tid = threadIdx.x;
    const int64_t doc = blockIdx.x;
    s_key += doc * n;
    s_op += doc * n;
    s_action += doc * n;
    s_value += doc * n;
    s_pred += doc * n;
    s_over += doc * n;
    c_key += doc * m;
    c_op += doc * m;
    c_action += doc * m;
    c_value += doc * m;
    c_pred += doc * m;

    if (tid == 0) {
        s_real = 0;
        s_hides = 0;
    }
    __syncthreads();
    int real = 0, hides = 0;
    for (int j = tid; j < m; j += kThreads) {
        const int32_t k = c_key[j];
        const int64_t p = c_pred[j];
        const bool hid = c_action[j] != kActionInc && p >= 0;
        u_mkey[j] = merge_key(k, c_op[j]);
        u_hide[j] = hid ? (shifted_key(k) | p) : kI64Max;
        real += k != kPadKey;
        hides += hid;
    }
    if (real) atomicAdd(&s_real, real);
    if (hides) atomicAdd(&s_hides, hides);
    __syncthreads();
    const int n_real = s_real;
    if (n_real == 0) return;   // padding only: nothing moves or hides
    const int n_hides = s_hides;

    // ranks, insertion points, the hides' first rows and h, one pass
    for (int q = tid; q <= 2 * m; q += kThreads) {
        if (q < m) {
            const int64_t mk = u_mkey[q], hk = u_hide[q];
            int r = 0, rh = 0;
            for (int i = 0; i < m; ++i) {
                const int64_t a = u_mkey[i], b = u_hide[i];
                r += a < mk || (a == mk && i < q);
                rh += b < hk || (b == hk && i < q);
            }
            src[r] = q;
            hide[rh] = hk;
            pos[q] = mk == kI64Max ? n : lower_bound_rows(s_key, s_op, n, mk);
        } else if (q < 2 * m) {
            const int64_t hk = u_hide[q - m];
            hide_at[q - m] =
                hk == kI64Max ? n : lower_bound_rows(s_key, s_op, n, hk);
        } else {
            int lo = 0, hi = n;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (s_key[mid] != kPadKey) lo = mid + 1;
                else hi = mid;
            }
            s_h = lo;
        }
    }
    __syncthreads();
    for (int r = tid; r < n_real; r += kThreads) slot[r] = pos[src[r]] + r;
    __syncthreads();
    const int h = s_h;
    const int end = min(h + n_real, n);
    const int start = min(slot[0], end);

    // hides of old rows that stay where they are
    for (int j = tid; j < m; j += kThreads) {
        const int64_t hk = u_hide[j];
        for (int i = hide_at[j]; i < start; ++i) {
            if (merge_key(s_key[i], s_op[i]) != hk) break;
            s_over[i] = 1;
        }
    }

    // rows start..end-1, a tile at a time from the top
    for (int hi = end; hi > start; hi -= kTile) {
        const int lo = max(hi - kTile, start);
        int32_t key[kRowsPerThread], action[kRowsPerThread];
        int64_t op[kRowsPerThread], value[kRowsPerThread];
        int64_t pred[kRowsPerThread];
        bool over[kRowsPerThread];
#pragma unroll
        for (int u = 0; u < kRowsPerThread; ++u) {
            const int t = lo + u * kThreads + tid;
            if (t >= hi) continue;
            const int k = count_at_or_below(slot, n_real, t);
            if (k > 0 && slot[k - 1] == t) {
                const int j = src[k - 1];
                key[u] = c_key[j];
                op[u] = c_op[j];
                action[u] = c_action[j];
                value[u] = c_value[j];
                pred[u] = c_pred[j];
                over[u] = false;
            } else {
                const int i = t - k;
                key[u] = s_key[i];
                op[u] = s_op[i];
                action[u] = s_action[i];
                value[u] = s_value[i];
                pred[u] = s_pred[i];
                over[u] = s_over[i] != 0;
            }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kRowsPerThread; ++u) {
            const int t = lo + u * kThreads + tid;
            if (t >= hi) continue;
            const int64_t mk = merge_key(key[u], op[u]);
            const bool hit = mk != kI64Max && in_sorted(hide, n_hides, mk);
            s_key[t] = key[u];
            s_op[t] = op[u];
            s_action[t] = action[u];
            s_value[t] = value[u];
            s_pred[t] = pred[u];
            s_over[t] = over[u] || hit;
        }
    }
    if (tid == 0) num_ops[doc] += n_real;
}

}  // namespace

extern "C" {

int dense_merge_launch(void* s_key, void* s_op, void* s_action,
                       void* s_value, void* s_pred, void* s_over,
                       void* num_ops, const void* c_key, const void* c_op,
                       const void* c_action, const void* c_value,
                       const void* c_pred, long long docs, int n, int m,
                       void* stream) {
    // m <= 1,228 (tpu/merge_kernels.py MAX_CHANGE_ROWS): within the 48 KiB
    // of dynamic shared memory a block has without opting in
    dense_merge_kernel<<<(unsigned)docs, kThreads, m * kSmemPerRow,
                         (cudaStream_t)stream>>>(
        (int32_t*)s_key, (int64_t*)s_op, (int32_t*)s_action,
        (int64_t*)s_value, (int64_t*)s_pred, (uint8_t*)s_over,
        (int32_t*)num_ops, (const int32_t*)c_key, (const int64_t*)c_op,
        (const int32_t*)c_action, (const int64_t*)c_value,
        (const int64_t*)c_pred, n, m);
    return (int)cudaGetLastError();
}

}  // extern "C"
