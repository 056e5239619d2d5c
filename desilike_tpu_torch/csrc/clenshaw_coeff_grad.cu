// Gradient of a batched Chebyshev series with respect to its coefficients, for Hopper (sm_90a).
//
// The backward companion of clenshaw.cu, which replaces the Pallas TPU kernel clenshaw_pallas
// (desilike_tpu/ops/pallas_kernels.py:30). The JAX package has no backward kernel: it gets this
// gradient from autodiff of its jnp recurrence (desilike_tpu/ops/chebyshev.py:106-118). With
// y[b, q] = sum_j c[b, j] T_j(x[b, q]) (then exp when log_values), the gradient of a loss with
// respect to the coefficients is, for each row b and degree j < order,
//     gc[b, j] = sum_q w[b, q] T_j(x[b, q]),
// with w = grad_y for a plain series and w = grad_y * y for an exp'd one (y is passed in and the
// product is taken at load). With coefficients shared by all rows the sum runs over b too. With
// per-row coefficients, x may be one row of q queries read by every row (shared_x), as the
// series kernel's shared x.
//
// The bound on the H100. The recurrence T_{j+1} = 2 x T_j - T_{j-1} is linear, so the kernel
// carries U_j = w T_j instead of T_j: one FFMA advances it and one FADD adds it to the sum, 3 FLOP
// a (query, degree). At B = 4096 chains and order 202 that is 0.71 GFLOP for the full-shape
// lookups (Q = 288), 10.7 us at the published 67 TFLOP/s of FP32, and 1.39 GFLOP, 20.7 us, at
// Q = 560; the bytes (x, grad_y and y read once, gc written once: 17.5 MB at Q = 288) take 5.2 us
// at 3.35 TB/s. Arithmetic bounds it. (The two instructions fill two FP32 issue slots, which a
// card that counts an FFMA as 2 FLOP clears in 4/3 of that time: 14.2 us and 27.7 us.)
//
// What the first design (one warp a row, 9 queries a lane at Q = 288) lost:
//   - Its loads were not overlapped with its arithmetic. At (4096, 288) its 512 blocks of 8 warps
//     fit the card in one wave, so every warp loaded its row first and no later work hid that.
//   - Overhead at every degree: for 18 FP32 instructions a lane (9 queries) it issued ~5.5 more:
//     a folding butterfly over 32 lanes (16 shuffles, 30 selects and 16 adds a chunk of 16
//     degrees, and a final xor-1 step after which every second lane idled at the store), the add
//     that joined two partial sums, the loop and the store: 2.69 instructions a (query, degree) in
//     its SASS, against the 2 of the bound.
//
// The design:
//   - A half-warp a row, NQ queries a lane (1, 9 or 18, a template parameter); a tile of a row is
//     16 x NQ queries, and longer rows are walked tile by tile with their sums added up (Q = 560:
//     two tiles of 288, which measured faster than a warp a row with one tile of 576). Lane l of a
//     team holds the queries l, l + 16, ... of its tile, each with 2x, U_j and U_{j+1} in
//     registers: NQ independent chains that hide the FFMA's latency. Slots past the end of a row
//     hold w = 0 and add nothing.
//   - No block-wide reduction at every degree: the degrees are walked in chunks of 16, each lane
//     adds its queries' U_j into 16 partial sums (two chains a degree, started from the first two
//     queries' terms, so NQ - 1 adds a degree), and the chunk is reduced across the team through
//     shared memory: each lane writes its 16 sums down a column of a 16 x 16 tile (rows 20 floats
//     apart), and lane l reads row l back with four 16-byte loads and adds it up: 16 stores, 4
//     loads and 15 adds a chunk, where a folding butterfly over the 16 lanes took 15 shuffles, 30
//     selects and 15 adds (1–11% slower at the shapes timed). The two teams of a warp write 16
//     banks apart.
//     At Q = 288 that is 2.27 instructions a (query, degree) in the SASS of the chunk loop.
//   - Persistent blocks that prefetch. The wrapper sizes the grid from the SM count times the
//     blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and team t walks the
//     units (row, tile) of rows t, t + teams, ... in order. Per-row coefficients with rows of a
//     multiple of 16 bytes and 16-byte aligned arrays: while a team runs the recurrence of one unit
//     from registers, cp.async (16 B a lane, .cg: through L2 only) copies the next unit's x,
//     grad_y and y into a buffer of the team's own in shared memory (3 x 16 x NQ floats, padded
//     so that the two teams of a warp read different banks); the team waits for it, moves it into
//     registers and issues the following copy. Nothing is copied past a team's last unit. A team's
//     first unit is loaded directly: its registers wait for their own loads only, so the recurrence
//     starts as the first of them land (copying the first unit too, and waiting for all of it, was
//     6% slower at (4096, 288), where every team has one unit and nothing is left to overlap).
//   - The loop over units runs as often for both teams of a warp (that of the warp's first team,
//     which has the most), so that every lane reaches the warp's synchronisations; a team without a
//     unit computes on w = 0 and stores nothing.
//   - U_j and U_{j+1} trade places every step, in place, so the loop body has no register moves.
//   - Shared coefficients (no prefetch): the teams of a warp add their sums together (one
//     shuffle), each warp adds into its own row of shared memory (no two lanes touch one degree),
//     and the block adds its warps' rows together at the end and issues one atomicAdd a degree and
//     block into gc, which the wrapper zeroes; the wrapper caps the grid so that the atomics stay
//     few. Their order varies between runs, within float32 rounding of a sum of a few hundred
//     terms.
//   - The forward recurrence in float32 drifts from the backward (Clenshaw) form by about 2e-5 of
//     the magnitude at order 202; the gradient is held to 1e-4 of its magnitude.
//   - Measured on the H100 (PERF.md): 42% of the bound at (4096, 288), against 37% for the first
//     design. The card issues at about 65% of what the instruction count allows, as it did for the
//     first design, and neither one block an SM nor three moved that: it is not the warps in
//     flight, nor the loads.
// Nothing is allocated here; the caller owns every array. Launches go on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 16;   // a team: the lanes a row
constexpr int TEAMS = 2;    // teams a warp
constexpr int CHUNK = 16;   // degrees reduced together
constexpr int MAX_WARPS = 8;
constexpr int FOLD_ROW = 20;                    // floats between the rows of a team's 16 x 16 tile
constexpr int FOLD_FLOATS = 16 * FOLD_ROW + 16;  // a team's tile, 16 banks past the last one's
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_OPT_IN_BYTES = 48 * 1024;  // shared memory, static and dynamic, a block gets without opting in

// floats of a team's prefetch buffer: x, grad_y and y of a tile, padded to 16 floats more than a
// multiple of 32, so that the two teams of a warp read their buffers on different banks
__host__ __device__ constexpr int buffer_floats(int nq) {
    return (3 * LANES * nq + 31) / 32 * 32 + 16;
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Copy tile `tile` of row `row` of x, grad_y and y (if not null) into `buffer`, 16 bytes a lane at a
// time. The caller passes rows < rows only and commits the group.
template <int NQ>
__device__ __forceinline__ void prefetch(float* buffer, const float* x, const float* grad_y, const float* y,
                                         long long row, int tile, int q, int sub, int shared_x) {
    constexpr int WIDTH = LANES * NQ;
    const long long start = row * q + static_cast<long long>(tile) * WIDTH;
    const long long xstart = shared_x ? static_cast<long long>(tile) * WIDTH : start;
    const int granules = min(WIDTH, q - tile * WIDTH) / 4;
    for (int g = sub; g < granules; g += LANES) {
        copy16(buffer + 4 * g, x + xstart + 4 * g);
        copy16(buffer + WIDTH + 4 * g, grad_y + start + 4 * g);
        if (y != nullptr) {
            copy16(buffer + 2 * WIDTH + 4 * g, y + start + 4 * g);
        }
    }
}

// rows x q queries; team t of the launch takes rows t, t + teams, ... and within each the tiles
// 0, 1, ... of 16 x NQ queries: units k = 0, 1, ... of row t + (k / tiles) teams.
// PER_ROW: gc is (rows, order) and written once. Otherwise gc is (order,), zeroed by the caller,
// and dynamic shared memory holds (warps a block) x padded floats, padded = order rounded up to
// CHUNK. PREFETCH (PER_ROW, q a multiple of 4, arrays 16-byte aligned): dynamic shared memory
// holds a buffer of buffer_floats(NQ) floats a team. shared_x (PER_ROW): x is one row of q queries.
template <int NQ, bool PER_ROW, bool PREFETCH>
__global__ void __launch_bounds__(32 * MAX_WARPS)
clenshaw_coeff_grad_kernel(const float* __restrict__ x, const float* __restrict__ grad_y,
                           const float* __restrict__ y, float* __restrict__ gc, int rows, int q, int order,
                           int shared_x) {
    static_assert(PER_ROW || !PREFETCH, "only per-row coefficients prefetch");
    constexpr int WIDTH = LANES * NQ;  // queries a tile
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(16) float fold_tiles[MAX_WARPS * TEAMS * FOLD_FLOATS];
    const int lane = threadIdx.x & 31;
    const int sub = lane & (LANES - 1);  // lane within the team; the degree of a chunk whose total it ends with
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int padded = (order + CHUNK - 1) / CHUNK * CHUNK;
    float* mine = smem + warp * padded;
    float* buffer = smem + (warp * TEAMS + lane / LANES) * buffer_floats(NQ);
    float* fold = fold_tiles + (warp * TEAMS + lane / LANES) * FOLD_FLOATS;
    if (!PER_ROW) {
        for (int i = threadIdx.x; i < warps * padded; i += blockDim.x) {
            smem[i] = 0.f;
        }
        __syncthreads();
    }
    const long long teams = static_cast<long long>(gridDim.x) * warps * TEAMS;
    const long long first = (static_cast<long long>(blockIdx.x) * warps + warp) * TEAMS;  // the warp's first team
    const long long team = first + lane / LANES;
    const int tiles = (q + WIDTH - 1) / WIDTH;
    // units of the warp's first team, which has the most: the loop runs as often for the whole warp
    const long long units = first < rows ? (rows - first + teams - 1) / teams * tiles : 0;
    // copy unit k + 1 of this team into its buffer, where it exists; one group either way
    auto copy_next = [&](long long k) {
        const long long next_row = team + (k + 1) / tiles * teams;
        if (k + 1 < units && next_row < rows) {
            prefetch<NQ>(buffer, x, grad_y, y, next_row, static_cast<int>((k + 1) % tiles), q, sub, shared_x);
        }
        copies_commit();
    };
    if (PREFETCH) {
        copy_next(0);  // the second unit, while the first one, loaded directly, computes
    }
    for (long long k = 0; k < units; ++k) {
        const long long step = k / tiles;
        const int tile = static_cast<int>(k - step * tiles);
        const long long row = team + step * teams;
        const bool live = row < rows;
        float two_x[NQ], ua[NQ], ub[NQ];  // ua = U_j, ub = U_{j+1} at even steps; swapped at odd ones
        if (PREFETCH && k > 0) {
            copies_wait();
            __syncwarp();  // every lane's copies of this unit have landed
#pragma unroll
            for (int n = 0; n < NQ; ++n) {
                const int i = sub + LANES * n;
                float xv = 0.f, wv = 0.f;
                if (live && tile * WIDTH + i < q) {
                    xv = buffer[i];
                    wv = buffer[WIDTH + i];
                    if (y != nullptr) {
                        wv *= buffer[2 * WIDTH + i];
                    }
                }
                two_x[n] = 2.f * xv;
                ua[n] = wv;       // w T_0
                ub[n] = wv * xv;  // w T_1
            }
            __syncwarp();  // every lane has read the buffer before it is refilled
            copy_next(k);
        } else {  // each register waits for its own load only: the recurrence starts as they land
            const long long start = row * q + static_cast<long long>(tile) * WIDTH;
            const long long xstart = shared_x ? static_cast<long long>(tile) * WIDTH : start;
#pragma unroll
            for (int n = 0; n < NQ; ++n) {
                const int i = sub + LANES * n;
                float xv = 0.f, wv = 0.f;
                if (live && tile * WIDTH + i < q) {
                    xv = x[xstart + i];
                    wv = grad_y[start + i];
                    if (y != nullptr) {
                        wv *= y[start + i];
                    }
                }
                two_x[n] = 2.f * xv;
                ua[n] = wv;
                ub[n] = wv * xv;
            }
        }
        for (int j0 = 0; j0 < order; j0 += CHUNK) {
            float acc[CHUNK];
#pragma unroll
            for (int jj = 0; jj < CHUNK; jj += 2) {
                float even[2], odd[2];  // two chains each: half the FADD latency
#pragma unroll
                for (int n = 0; n < NQ; ++n) {
                    even[n & 1] = n < 2 ? ua[n] : even[n & 1] + ua[n];
                    ua[n] = fmaf(two_x[n], ub[n], -ua[n]);  // U_{j+2}
                }
#pragma unroll
                for (int n = 0; n < NQ; ++n) {
                    odd[n & 1] = n < 2 ? ub[n] : odd[n & 1] + ub[n];
                    ub[n] = fmaf(two_x[n], ua[n], -ub[n]);  // U_{j+3}
                }
                acc[jj] = NQ > 1 ? even[0] + even[1] : even[0];
                acc[jj + 1] = NQ > 1 ? odd[0] + odd[1] : odd[0];
            }
            // the team's 16 x 16 partial sums, transposed through shared memory: lane `sub` writes
            // its sums down column sub, then reads row sub, the partial sums of degree j0 + sub
#pragma unroll
            for (int d = 0; d < CHUNK; ++d) {
                fold[d * FOLD_ROW + sub] = acc[d];
            }
            __syncwarp();
            const float4* part = reinterpret_cast<const float4*>(fold + sub * FOLD_ROW);
            const float4 a = part[0], b = part[1], c = part[2], e = part[3];
            float total = (((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w)))
                          + (((c.x + c.y) + (c.z + c.w)) + ((e.x + e.y) + (e.z + e.w)));
            __syncwarp();  // every lane has read its row before the next chunk's sums are written
            const int j = j0 + sub;
            if (PER_ROW) {
                if (live && j < order) {
                    float* dst = gc + row * order + j;
                    *dst = tile == 0 ? total : *dst + total;  // this lane wrote the earlier tiles' sum
                }
            } else {
                total += __shfl_xor_sync(FULL, total, 16);  // the warp's other team (w = 0 if it has no row)
                if (lane < LANES) {
                    mine[j] += total;  // j < padded; only this lane of this warp touches it
                }
            }
        }
    }
    if (!PER_ROW) {
        __syncthreads();
        for (int j = threadIdx.x; j < order; j += blockDim.x) {
            float sum = 0.f;
            for (int w = 0; w < warps; ++w) {
                sum += smem[w * padded + j];
            }
            atomicAdd(gc + j, sum);
        }
    }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int);

template <int NQ>
Kernel variant(int per_row, int prefetch) {
    if (!per_row) {
        return clenshaw_coeff_grad_kernel<NQ, false, false>;
    }
    return prefetch ? clenshaw_coeff_grad_kernel<NQ, true, true> : clenshaw_coeff_grad_kernel<NQ, true, false>;
}

// The compiled instances: 1, 9 or 18 queries a lane.
Kernel find(int nq, int per_row, int prefetch) {
    if (prefetch && !per_row) {
        return nullptr;
    }
    switch (nq) {
        case 1: return variant<1>(per_row, prefetch);
        case 9: return variant<9>(per_row, prefetch);
        case 18: return variant<18>(per_row, prefetch);
        default: return nullptr;
    }
}

// The instance, its block size checked and, where its static shared memory (the fold tiles) and
// `smem` bytes of dynamic shared memory pass 48 KB, the opt-in made.
cudaError_t prepare(int nq, int per_row, int prefetch, int warps, int smem, Kernel* kernel) {
    *kernel = find(nq, per_row, prefetch);
    if (*kernel == nullptr || warps < 1 || warps > MAX_WARPS || smem < 0) {
        return cudaErrorInvalidValue;
    }
    cudaFuncAttributes attributes;
    cudaError_t err = cudaFuncGetAttributes(&attributes, reinterpret_cast<const void*>(*kernel));
    if (err == cudaSuccess && attributes.sharedSizeBytes + smem > NO_OPT_IN_BYTES) {
        err = cudaFuncSetAttribute(reinterpret_cast<const void*>(*kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
    }
    return err;
}

}  // namespace

// x, grad_y: (rows, q) float32, contiguous (x (q,) read by every row when shared_x, per_row
// only); y: the forward's exp'd output (rows, q) when the series was exp'd, else null; gc: (rows, order) when per_row, else (order,) zeroed by the
// caller. nq: queries a lane (1, 9 or 18); prefetch: copy each team's next unit into shared memory
// ahead of its use (per_row only; q a multiple of 4 and the arrays 16-byte aligned); warps: a
// block (1 to 8); smem: dynamic shared memory of a block in bytes; grid: blocks. All come from
// the wrapper. Launches on `stream` and returns the value of cudaGetLastError() (0 on success), or
// the error of the shared-memory opt-in; an uncompiled instance returns cudaErrorInvalidValue.
extern "C" int clenshaw_coeff_grad_f32(const void* x, const void* grad_y, const void* y, void* gc, int rows,
                                       int q, int order, int per_row, int nq, int prefetch, int warps, int smem,
                                       int grid, int shared_x, void* stream) {
    if (rows <= 0 || q <= 0 || order <= 0 || grid <= 0) {
        return 0;
    }
    if (shared_x && !per_row) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Kernel kernel;
    cudaError_t err = prepare(nq, per_row, prefetch, warps, smem, &kernel);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(grad_y), static_cast<const float*>(y),
        static_cast<float*>(gc), rows, q, order, shared_x);
    return static_cast<int>(cudaGetLastError());
}

// The blocks of this instance that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *blocks; returns the CUDA error (0 on success).
extern "C" int clenshaw_coeff_grad_occupancy(int per_row, int nq, int prefetch, int warps, int smem, int* blocks) {
    Kernel kernel;
    cudaError_t err = prepare(nq, per_row, prefetch, warps, smem, &kernel);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, reinterpret_cast<const void*>(kernel), 32 * warps, smem));
}
