// Gradient of a batched Chebyshev series with respect to its coefficients, for Hopper (sm_90a).
//
// The backward companion of clenshaw.cu, which replaces the Pallas TPU kernel clenshaw_pallas
// (desilike_tpu/ops/pallas_kernels.py:30). The JAX package has no backward kernel: it gets this
// gradient from autodiff of its jnp recurrence (desilike_tpu/ops/chebyshev.py:106-118). With
// y[b, q] = sum_j c[b, j] T_j(x[b, q]) (then exp when log_values), the gradient of a loss with
// respect to the coefficients is, for each row b and degree j < order,
//     gc[b, j] = sum_q w[b, q] T_j(x[b, q]),
// with w = grad_y for a plain series and w = grad_y * y for an exp'd one (y is passed in and the
// product is taken at load). With coefficients shared by all rows the sum runs over b too.
//
// The bound on the H100. The recurrence T_{j+1} = 2 x T_j - T_{j-1} is linear, so the kernel
// carries U_j = w T_j instead of T_j: one FFMA advances it and one FADD adds it to the sum, 3 FLOP
// a (query, degree). At B = 4096 chains and order 202 that is 0.71 GFLOP for the full-shape
// lookups (Q = 288), 10.7 us at the published 67 TFLOP/s of FP32, and 1.39 GFLOP, 20.7 us, at
// Q = 560; the bytes (x, w and y read once, gc written once) take under 10 us at 3.35 TB/s.
// Arithmetic bounds it. (The two instructions fill two FP32 issue slots, which a card that counts
// an FFMA as 2 FLOP clears in 4/3 of that time: 14.2 us and 27.7 us.)
//
// The design:
//   - One warp a row. Lane l holds the queries l, l + 32, l + 64, ... of the row (coalesced
//     loads), NQ of them (a template parameter, ceil(Q / 32) rounded up to one of the compiled
//     values 1, 9 and 18: one query a lane, and the two widths of the likelihoods' lookups, 288
//     and 560; rows longer than 32 x 18 queries are walked in column tiles and their sums added up), each with
//     2x, U_j and U_{j+1} in registers: 3 NQ registers, and NQ independent chains that hide the
//     FFMA's latency. Slots past the end of a row hold w = 0 and add nothing.
//   - No block-wide reduction at every degree: the degrees are walked in chunks of 16, each lane
//     adds its queries' U_j into 16 partial sums, and the chunk is reduced across the warp by a
//     folding butterfly: at each of four steps a lane keeps one half of its sums and sends the
//     other half to its partner, so 8 + 4 + 2 + 1 + 1 = 16 shuffles reduce 16 sums over 32 lanes
//     (5 x 16 = 80 with one butterfly a sum). Lane l ends with the total of degree (l >> 1) & 15
//     of the chunk, and the even lanes store 16 consecutive floats.
//   - U_j and U_{j+1} trade places every step, in place, so the loop body has no register moves.
//   - Per-row coefficients: the even lanes store straight to gc[b, j]. Shared coefficients: each
//     warp adds its rows' sums into its own row of shared memory (no two lanes touch one degree),
//     the block adds its warps' rows together at the end and issues one atomicAdd a degree and
//     block into gc, which the wrapper zeroes; the wrapper caps the grid so that the atomics stay
//     few. Their order varies between runs, within float32 rounding of a sum of a few hundred
//     terms.
//   - The wrapper (cuda_kernels.coeff_grad_geometry) chooses NQ, the warps a block and the grid;
//     rows past the grid are walked with a stride. Shared memory stays within the 48 KB that needs
//     no opt-in.
//   - The forward recurrence in float32 drifts from the backward (Clenshaw) form by about 2e-5 of
//     the magnitude at order 202; the gradient is held to 1e-4 of its magnitude.
// Nothing is allocated here; the caller owns every array. Launches go on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 16;  // degrees reduced together

// One folding step of the butterfly: `upper` lanes keep sums [HALF, 2 HALF), the others
// [0, HALF), each adding its partner's copy of the half it keeps.
template <int HALF>
__device__ __forceinline__ void fold(float (&acc)[CHUNK], bool upper, int lane_mask) {
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
        const float send = upper ? acc[i] : acc[i + HALF];
        const float keep = upper ? acc[i + HALF] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, lane_mask);
    }
}

// rows x q queries; warp w of the launch takes rows w, w + (warps in the grid), ...
// PER_ROW: gc is (rows, order) and written once. Otherwise gc is (order,), zeroed by the caller,
// and dynamic shared memory holds (warps a block) x padded floats, padded = order rounded up to
// CHUNK.
template <int NQ, bool PER_ROW>
__global__ void __launch_bounds__(256)
clenshaw_coeff_grad_kernel(const float* __restrict__ x, const float* __restrict__ grad_y,
                           const float* __restrict__ y, float* __restrict__ gc, int rows, int q, int order) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int padded = (order + CHUNK - 1) / CHUNK * CHUNK;
    float* mine = smem + warp * padded;
    if (!PER_ROW) {
        for (int i = threadIdx.x; i < warps * padded; i += blockDim.x) {
            smem[i] = 0.f;
        }
        __syncthreads();
    }
    const int degree = (lane >> 1) & (CHUNK - 1);  // the degree of a chunk whose total this lane ends with
    const long long stride = static_cast<long long>(gridDim.x) * warps;
    for (long long row = static_cast<long long>(blockIdx.x) * warps + warp; row < rows; row += stride) {
        const float* xrow = x + row * q;
        const float* grow = grad_y + row * q;
        const float* yrow = y == nullptr ? nullptr : y + row * q;
        for (int q0 = 0; q0 < q; q0 += 32 * NQ) {
            float two_x[NQ], ua[NQ], ub[NQ];  // ua = U_j, ub = U_{j+1} at even steps; swapped at odd ones
#pragma unroll
            for (int n = 0; n < NQ; ++n) {
                const int qq = q0 + lane + 32 * n;
                float xv = 0.f, wv = 0.f;
                if (qq < q) {
                    xv = xrow[qq];
                    wv = grow[qq];
                    if (yrow != nullptr) {
                        wv *= yrow[qq];
                    }
                }
                two_x[n] = 2.f * xv;
                ua[n] = wv;       // w T_0
                ub[n] = wv * xv;  // w T_1
            }
            for (int j0 = 0; j0 < order; j0 += CHUNK) {
                float acc[CHUNK];
#pragma unroll
                for (int jj = 0; jj < CHUNK; jj += 2) {
                    float even[2] = {0.f, 0.f}, odd[2] = {0.f, 0.f};  // two chains each: half the FADD latency
#pragma unroll
                    for (int n = 0; n < NQ; ++n) {
                        even[n & 1] += ua[n];
                        ua[n] = fmaf(two_x[n], ub[n], -ua[n]);  // U_{j+2}
                    }
#pragma unroll
                    for (int n = 0; n < NQ; ++n) {
                        odd[n & 1] += ub[n];
                        ub[n] = fmaf(two_x[n], ua[n], -ub[n]);  // U_{j+3}
                    }
                    acc[jj] = even[0] + even[1];
                    acc[jj + 1] = odd[0] + odd[1];
                }
                fold<8>(acc, (lane & 16) != 0, 16);
                fold<4>(acc, (lane & 8) != 0, 8);
                fold<2>(acc, (lane & 4) != 0, 4);
                fold<1>(acc, (lane & 2) != 0, 2);
                const float total = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
                const int j = j0 + degree;
                if ((lane & 1) == 0) {
                    if (PER_ROW) {
                        if (j < order) {
                            float* dst = gc + row * order + j;
                            *dst = q0 == 0 ? total : *dst + total;  // this lane wrote the earlier tiles' sum
                        }
                    } else {
                        mine[j] += total;  // j < padded; only this lane of this warp touches it
                    }
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

template <int NQ>
cudaError_t launch(const float* x, const float* grad_y, const float* y, float* gc, int rows, int q, int order,
                   int per_row, int warps, int grid, cudaStream_t stream) {
    if (per_row) {
        clenshaw_coeff_grad_kernel<NQ, true><<<grid, 32 * warps, 0, stream>>>(x, grad_y, y, gc, rows, q, order);
    } else {
        const int padded = (order + CHUNK - 1) / CHUNK * CHUNK;
        const size_t smem = static_cast<size_t>(warps) * padded * sizeof(float);
        clenshaw_coeff_grad_kernel<NQ, false><<<grid, 32 * warps, smem, stream>>>(x, grad_y, y, gc, rows, q, order);
    }
    return cudaGetLastError();
}

}  // namespace

// x, grad_y: (rows, q) float32, contiguous; y: the forward's exp'd output (rows, q) when the
// series was exp'd, else null; gc: (rows, order) when per_row, else (order,) zeroed by the
// caller. nq: queries a lane (one of the compiled values below); warps: a block (1 to 8); grid:
// blocks. All three come from the wrapper. Launches on `stream` and returns the value of
// cudaGetLastError() (0 on success); an unsupported nq or warps returns cudaErrorInvalidValue.
extern "C" int clenshaw_coeff_grad_f32(const void* x, const void* grad_y, const void* y, void* gc, int rows,
                                       int q, int order, int per_row, int nq, int warps, int grid,
                                       void* stream) {
    if (rows <= 0 || q <= 0 || order <= 0 || grid <= 0) {
        return 0;
    }
    if (warps < 1 || warps > 8) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(grad_y);
    const float* yf = static_cast<const float*>(y);
    float* cf = static_cast<float*>(gc);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (nq) {
#define COEFF_GRAD_CASE(NQ)                                                                      \
        case NQ:                                                                                 \
            err = launch<NQ>(xf, gf, yf, cf, rows, q, order, per_row, warps, grid, s);           \
            break;
        COEFF_GRAD_CASE(1)
        COEFF_GRAD_CASE(9)
        COEFF_GRAD_CASE(18)
#undef COEFF_GRAD_CASE
        default:
            err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
