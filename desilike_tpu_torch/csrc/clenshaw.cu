// Batched Chebyshev series evaluation by the Clenshaw recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel clenshaw_pallas (desilike_tpu/ops/pallas_kernels.py:30).
// For each row b and query q:
//     y[b, q] = sum_{j < order} c[b, j] T_j(x[b, q])
// computed by b_k = 2 x b_{k+1} - b_{k+2} + c_k (k = order-1 .. 1), y = c_0 + x b_1 - b_2
// (full c_0 convention, as ChebyshevLogInterp.evaluate), then y = exp(y) when log_values
// is set. The coefficients are either one row shared by every row of x, or one row per row.
// With per-row coefficients, x may also be one row of q queries that every row reads
// (shared_x: the TNS tables' static (k, q, mu) grid, 460800 queries, looked up with each
// chain's coefficients), so that no (rows, q) copy of it is made.
//
// The bound on the H100. On the BAO main path (B = 4096 chains, Q = 560 queries a chain,
// order 202) the work is 2.29 M queries x 201 steps x 3 FLOP (an FFMA and an FADD) =
// 1.38 GFLOP, 20.6 us at the published 67 TFLOP/s of FP32; the bytes (x read once, y written
// once, 18.4 MB) take 5.5 us at 3.35 TB/s. Arithmetic bounds it: 20.6 us a launch. Two FP32
// issue slots a step are the floor of any recurrence written this way: 461 M step-queries x 2
// over 132 SMs x 128 lanes at 1.98 GHz is 27.6 us, 75% of the bound.
//
// What limited the first design (one thread a query, 256-thread blocks on a (query tile, row)
// grid; about 70 us, 29% of the bound):
//   1. one shared-memory load of c[j] a step: an SM serves one shared wavefront a clock but
//      issues four FP32 warp-instructions, so the loads capped it at half its FP32 rate;
//   2. a runtime `order` loop, so a counter and a branch every step;
//   3. fmaf(2x, b1, -b2) + c[j]: two dependent operations on every step's critical path;
//   4. its grid: a 560-query row took three 256-thread blocks (the third 48 threads live),
//      and the (56, 1) lookup took 56 blocks with one live thread each.
//
// What this design does about it:
//   - Each thread runs K independent recurrences (K a template parameter; 4 by default), all
//     on one coefficient row, so one coefficient load feeds K chains and the K chains hide the
//     FFMA's latency.
//   - The coefficients are staged in shared memory zero-padded to a multiple of 4 and read as
//     float4 broadcasts: one shared load per 4 steps per thread, issued a chunk ahead of its
//     use. The padding is exact: zero terms above the top degree leave b1 = b2 = 0. The inner
//     loop is unrolled by 4 at compile time.
//   - A step is b_j = fmaf(2x, b_{j+1}, c_j - b_{j+2}): the FADD reads b_{j+2}, a step old, so
//     only the FFMA is on the dependent chain. b1 and b2 trade places every step, in place, so
//     the 4-step body needs no register moves. The compiled inner loop is 2 FP32 instructions,
//     1/16 of a shared load and about 0.08 other instructions a step-query at K = 4.
//   - Geometry, chosen by the wrapper (cuda_kernels.clenshaw_geometry), which the CPU tests
//     check covers every (row, query) once:
//       flat layout: rows x Q is one index space; a block of up to 256 threads takes a tile of
//       256 K consecutive queries, K to a thread, with float4 loads and stores when x and y
//       are 16-byte aligned and K is a multiple of 4 (scalar otherwise, e.g. a view with a
//       storage offset). Shared coefficients are staged once a block; per-row coefficients
//       take this layout when K divides Q (a thread's queries then lie in one row) and each
//       tile stages the few rows it spans. No lane idles but in the last tile, and the (56, 1)
//       lookup is one 32-thread block.
//       row layout, for per-row coefficients otherwise (odd Q, such as 1, 3 or 561, or rows
//       too long for the rows a flat tile spans to fit 48 KB): a block takes R rows (R chosen
//       so that few lanes idle) and stages their R coefficient rows; within a row, thread i
//       takes queries i + k W (k < K, W = ceil(Q / K) threads a row). Rows longer than 512
//       threads split into column tiles of 256 threads.
//     Both walk their tiles with a grid stride past the grid the wrapper launches (65535
//     blocks at most), and mask ragged tails.
//   - Registers are capped at 32 for K <= 4 (launch bounds), which keeps 64 warps on an SM;
//     the flat kernel used 38 without the cap and ran slower.
//   - Shared memory stays within the 48 KB that needs no opt-in: the wrapper limits the rows a
//     block stages so that they fit, and rejects orders above 12288 with a clear error.
//   - expf, not __expf, and no fast-math flags: the result stays within 1e-5 of the plain
//     float32 version's magnitude.
// Nothing is allocated here; the caller owns x, coeffs and y. Launches go on the caller's
// stream, so they can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

// K recurrences over one padded coefficient row (`chunks` float4s, c[4m .. 4m + 3] in
// chunk m); v holds the K queries on entry and the K series values on exit.
template <int K>
__device__ __forceinline__ void clenshaw_series(const float4* __restrict__ c4, int chunks,
                                                float (&v)[K]) {
    float two_x[K], b1[K], b2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        two_x[k] = 2.f * v[k];
        b1[k] = 0.f;  // b_{j+1}
        b2[k] = 0.f;  // b_{j+2}
    }
    float4 c = c4[chunks - 1];
    for (int m = chunks - 1; m > 0; --m) {
        const float4 next = c4[m - 1];  // in flight while chunk m is used
#pragma unroll
        for (int k = 0; k < K; ++k) {
            b2[k] = fmaf(two_x[k], b1[k], c.w - b2[k]);  // b_{4m+3}
            b1[k] = fmaf(two_x[k], b2[k], c.z - b1[k]);  // b_{4m+2}
            b2[k] = fmaf(two_x[k], b1[k], c.y - b2[k]);  // b_{4m+1}
            b1[k] = fmaf(two_x[k], b2[k], c.x - b1[k]);  // b_{4m}
        }
        c = next;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        b2[k] = fmaf(two_x[k], b1[k], c.w - b2[k]);  // b_3
        b1[k] = fmaf(two_x[k], b2[k], c.z - b1[k]);  // b_2
        b2[k] = fmaf(two_x[k], b1[k], c.y - b2[k]);  // b_1
        v[k] = fmaf(v[k], b2[k], c.x - b1[k]);       // c_0 + x b_1 - b_2
    }
}

// Copies `rows` coefficient rows of length `order` (row stride `order`) into shared memory,
// each zero-padded to `padded`; rows past `valid` are zero.
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ coeffs,
                                      int rows, int valid, int order, int padded) {
    for (int r = 0; r < rows; ++r) {  // no integer division: it costs tens of instructions
        const float* src = coeffs + static_cast<long long>(r) * order;
        for (int i = threadIdx.x; i < padded; i += blockDim.x) {
            dst[r * padded + i] = (r < valid && i < order) ? src[i] : 0.f;
        }
    }
}

// The row of flat query `index` in rows of q (a 64-bit integer division is a call of about a
// hundred instructions; a double product and one correction are exact below 2^52).
__device__ __forceinline__ long long row_of(long long index, int q, double inv_q) {
    long long row = static_cast<long long>(static_cast<double>(index) * inv_q);
    if (row * q > index) {
        --row;
    } else if ((row + 1) * q <= index) {
        ++row;
    }
    return row;
}

// The flat layout: tile t holds the flat queries [t T K, (t + 1) T K) of the rows x q index
// space, thread i of the tile the K consecutive ones from (t T + i) K. Shared coefficients are
// staged once. Per-row coefficients (PER_ROW; the wrapper takes it only when K divides q, so a
// thread's K queries lie in one row): each tile stages the rows it spans, at most `window`.
// At most 32 registers for K <= 4: 8 blocks of 256 threads, 64 warps, on an SM. shared_x (PER_ROW
// only): x is one row of q queries, read by every row at its own offset.
template <int K, bool VEC, bool PER_ROW>  // VEC only with K a multiple of 4
__global__ void __launch_bounds__(256, K <= 4 ? 8 : 4) clenshaw_flat_kernel(const float* __restrict__ x, const float* __restrict__ coeffs,
                                     float* __restrict__ out, long long n, int q, int order, int chunks,
                                     int log_values, long long tiles, int shared_x) {
    extern __shared__ float4 smem[];
    if (!PER_ROW) {
        stage(reinterpret_cast<float*>(smem), coeffs, 1, 1, order, 4 * chunks);
        __syncthreads();
    }
    const double inv_q = 1. / q;
    const long long span = static_cast<long long>(blockDim.x) * K;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long base = tile * span + threadIdx.x * K;
        long long row0 = 0;
        if (PER_ROW) {  // uniform across the block
            row0 = row_of(tile * span, q, inv_q);
            const long long last = (tile + 1) * span < n ? (tile + 1) * span - 1 : n - 1;
            const int count = static_cast<int>(row_of(last, q, inv_q) - row0) + 1;
            __syncthreads();  // every thread is done with the previous tile's coefficients
            stage(reinterpret_cast<float*>(smem), coeffs + row0 * order, count, count, order, 4 * chunks);
            __syncthreads();
        }
        if (base >= n) {
            continue;
        }
        const long long row = PER_ROW ? row_of(base, q, inv_q) : 0;
        // the thread's K queries lie in one row: with a shared x, at that row's offset in it
        const float* xs = x + (PER_ROW && shared_x ? base - row * q : base);
        const long long xn = PER_ROW && shared_x ? (row + 1) * q - base : n - base;
        bool whole = false;  // all K queries in range, loaded and stored as float4s
        float v[K];
        if constexpr (VEC) {
            whole = base + K <= n;
            if (whole) {
#pragma unroll
                for (int k = 0; k < K; k += 4) {
                    const float4 q4 = *reinterpret_cast<const float4*>(xs + k);
                    v[k] = q4.x;
                    v[k + 1] = q4.y;
                    v[k + 2] = q4.z;
                    v[k + 3] = q4.w;
                }
            }
        }
        if (!whole) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                v[k] = k < xn ? xs[k] : 0.f;
            }
        }
        const float4* c4 = smem;
        if (PER_ROW) {
            c4 += (row - row0) * chunks;
        }
        clenshaw_series<K>(c4, chunks, v);
        if (log_values) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                v[k] = expf(v[k]);
            }
        }
        if constexpr (VEC) {
            if (whole) {
#pragma unroll
                for (int k = 0; k < K; k += 4) {
                    *reinterpret_cast<float4*>(out + base + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
                }
            }
        }
        if (!whole) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (base + k < n) {
                    out[base + k] = v[k];
                }
            }
        }
    }
}

// The row layout, for per-row coefficients that the flat layout does not take (no K divides q,
// or the rows a flat tile spans do not fit 48 KB): tile t covers rows [g R, g R + R) with
// g = t / col_tiles, and the queries [s W K, (s + 1) W K) of each, s = t % col_tiles; thread
// r W + i takes row g R + r, queries s W K + i + k W (k < K). Threads from R W up to the block
// size idle.
template <int K>  // at most 32 registers for K <= 4: 7 blocks of 288 threads on an SM
__global__ void __launch_bounds__(512, K <= 4 ? 4 : 2)
clenshaw_rows_kernel(const float* __restrict__ x, const float* __restrict__ coeffs, float* __restrict__ out,
                     int rows, int q, int order, int chunks, int log_values, int rows_per_block,
                     int row_threads, int col_tiles, long long tiles, int shared_x) {
    extern __shared__ float4 smem[];
    const int r = threadIdx.x / row_threads;
    const int i = threadIdx.x - r * row_threads;
    long long staged = -1;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long group = col_tiles == 1 ? tile : tile / col_tiles;
        const int col = static_cast<int>(tile - group * col_tiles);
        const long long row0 = group * rows_per_block;
        if (group != staged) {  // uniform across the block
            __syncthreads();    // every thread is done with the previous rows' coefficients
            const long long left = rows - row0;
            stage(reinterpret_cast<float*>(smem), coeffs + row0 * order, rows_per_block,
                  left < rows_per_block ? static_cast<int>(left) : rows_per_block, order, 4 * chunks);
            __syncthreads();
            staged = group;
        }
        const long long row = row0 + r;
        if (r >= rows_per_block || row >= rows) {
            continue;
        }
        const float* xrow = shared_x ? x : x + row * q;
        float* orow = out + row * q;
        const int q0 = col * row_threads * K + i;
        float v[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int qq = q0 + k * row_threads;
            v[k] = qq < q ? xrow[qq] : 0.f;
        }
        clenshaw_series<K>(smem + r * chunks, chunks, v);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int qq = q0 + k * row_threads;
            if (qq < q) {
                orow[qq] = log_values ? expf(v[k]) : v[k];
            }
        }
    }
}

template <int K, bool PER_ROW>
void launch_flat(const float* x, const float* coeffs, float* out, long long n, int q, int order, int chunks,
                 int log_values, int vec, int threads, long long tiles, int grid, size_t smem, int shared_x,
                 cudaStream_t stream) {
    if constexpr (K % 4 == 0) {
        if (vec) {
            clenshaw_flat_kernel<K, true, PER_ROW><<<grid, threads, smem, stream>>>(
                x, coeffs, out, n, q, order, chunks, log_values, tiles, shared_x);
            return;
        }
    }
    clenshaw_flat_kernel<K, false, PER_ROW><<<grid, threads, smem, stream>>>(
        x, coeffs, out, n, q, order, chunks, log_values, tiles, shared_x);
}

template <int K>
cudaError_t launch(const float* x, const float* coeffs, float* out, int rows, int q, int order, int per_row,
                   int log_values, int vec, int flat, int threads, int rows_per_block, int row_threads,
                   int col_tiles, long long tiles, int grid, int shared_x, cudaStream_t stream) {
    const int chunks = (order + 3) / 4;
    const size_t smem = static_cast<size_t>(rows_per_block) * chunks * sizeof(float4);
    const long long n = static_cast<long long>(rows) * q;
    if (!flat) {
        clenshaw_rows_kernel<K><<<grid, threads, smem, stream>>>(
            x, coeffs, out, rows, q, order, chunks, log_values, rows_per_block, row_threads, col_tiles, tiles,
            shared_x);
    } else if (per_row) {
        launch_flat<K, true>(x, coeffs, out, n, q, order, chunks, log_values, vec, threads, tiles, grid, smem,
                             shared_x, stream);
    } else {
        launch_flat<K, false>(x, coeffs, out, n, q, order, chunks, log_values, vec, threads, tiles, grid, smem,
                              0, stream);
    }
    return cudaGetLastError();
}

}  // namespace

// x: (rows, q) float32, contiguous, or (q,) read by every row when shared_x (per_row only);
// coeffs: (order,) when per_row is 0, else (rows, order), contiguous; out: (rows, q). k: queries a thread (2, 4 or 8). The launch geometry
// (flat or row layout, threads, rows_per_block: the coefficient rows staged a block,
// row_threads, col_tiles, tiles, grid) and vec (x and out 16-byte aligned) come from the
// wrapper. Launches on `stream` and returns the value of cudaGetLastError() (0 on success); an
// unsupported k returns cudaErrorInvalidValue.
extern "C" int clenshaw_f32(const void* x, const void* coeffs, void* out, int rows, int q, int order,
                            int per_row, int log_values, int k, int vec, int flat, int threads,
                            int rows_per_block, int row_threads, int col_tiles, long long tiles, int grid,
                            int shared_x, void* stream) {
    if (rows <= 0 || q <= 0 || tiles <= 0) {
        return 0;
    }
    if (shared_x && !per_row) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const float* xf = static_cast<const float*>(x);
    const float* cf = static_cast<const float*>(coeffs);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (k) {
#define CLENSHAW_CASE(K)                                                                                 \
        case K:                                                                                         \
            err = launch<K>(xf, cf, of, rows, q, order, per_row, log_values, vec, flat, threads,        \
                            rows_per_block, row_threads, col_tiles, tiles, grid, shared_x, s);          \
            break;
        CLENSHAW_CASE(2)
        CLENSHAW_CASE(4)
        CLENSHAW_CASE(8)
#undef CLENSHAW_CASE
        default:
            err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
