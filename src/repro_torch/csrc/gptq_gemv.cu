// Fused W4A16 GEMV for decode (M <= 8): y = x @ dequant(qweight) + bias.
//
// Replaces: repro/kernels/gptq_gemv.py::gptq_gemv -> _kernel_gemv (the
// Pallas decode fast lane).
//
// Bound on the H100: bytes.  At M <= 8 every packed weight word is used for
// at most 8 * 8 multiply-adds, far below the ~295 operations per byte the
// card needs before compute is the limit, so the time floor is reading
// qweight (K*N/2 bytes) plus scales and zeros once.
//
// Design: one block per 128-column tile of N with the whole K loop inside
// (the SMB idea): 256 threads, two K slices of 128 columns each.  Each
// thread streams packed int32 words down its column (neighbouring threads
// read neighbouring columns, so every warp load is one 128-byte line),
// unpacks the 8 nibbles with unsigned shifts, dequantizes (q - z) * s in
// float32 and accumulates all M rows in registers.  x is staged through
// shared memory 512 K-values at a time as float32.  The two K slices are
// reduced in shared memory and written back once, with the bias fused into
// that writeback.  The ragged edge of N is masked in the kernel.  There is
// no split-K across blocks, so small N launches few blocks (8 for N = 1024).
#include "common.cuh"

namespace {

constexpr int BN = 128;      // output columns per block
constexpr int KSPLIT = 2;    // K slices per block; threads = BN * KSPLIT
constexpr int KC = 512;      // x values per row staged in shared memory
constexpr int MMAX = 8;      // decode rows served by this lane

template <typename TX, typename TS>
__global__ void __launch_bounds__(BN * KSPLIT)
gemv_kernel(const TX* __restrict__ x, const int32_t* __restrict__ qw,
            const TS* __restrict__ scales, const int32_t* __restrict__ qz,
            const float* __restrict__ bias, TX* __restrict__ y,
            int M, int K, int N, int group) {
  __shared__ float xs[MMAX][KC];
  __shared__ float red[KSPLIT - 1][MMAX][BN];
  const int col = threadIdx.x % BN;
  const int slice = threadIdx.x / BN;
  const int n = blockIdx.x * BN + col;
  const bool live = n < N;
  float acc[MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < M * kc; i += blockDim.x) {
      const int m = i / kc, kk = i - m * kc;
      xs[m][kk] = to_f32(x[(size_t)m * K + k0 + kk]);
    }
    __syncthreads();
    if (live) {
      for (int w = slice; w < kc / 8; w += KSPLIT) {
        const int k = k0 + 8 * w;
        const uint32_t word = (uint32_t)qw[(size_t)(k >> 3) * N + n];
        const int gi = k / group;           // group % 8 == 0: one group/word
        const float s = to_f32(scales[(size_t)gi * N + n]);
        const float z = zero_point(qz + (size_t)gi * (N >> 3), n);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float wv = (nibble(word, i) - z) * s;
#pragma unroll
          for (int m = 0; m < MMAX; ++m)
            if (m < M) acc[m] = fmaf(xs[m][8 * w + i], wv, acc[m]);
        }
      }
    }
  }
  if (slice > 0) {
#pragma unroll
    for (int m = 0; m < MMAX; ++m)
      if (m < M) red[slice - 1][m][col] = acc[m];
  }
  __syncthreads();
  if (slice == 0 && live) {
    const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
    for (int m = 0; m < MMAX; ++m) {
      if (m >= M) break;
      float v = acc[m];
      for (int s = 1; s < KSPLIT; ++s) v += red[s - 1][m][col];
      y[(size_t)m * N + n] = from_f32<TX>(v + b);
    }
  }
}

template <typename TX, typename TS>
void launch(const void* x, const void* qw, const void* scales, const void* qz,
            const void* bias, void* y, int M, int K, int N, int group,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN), block(BN * KSPLIT);
  gemv_kernel<TX, TS><<<grid, block, 0, stream>>>(
      (const TX*)x, (const int32_t*)qw, (const TS*)scales,
      (const int32_t*)qz, (const float*)bias, (TX*)y, M, K, N, group);
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched).
extern "C" int gptq_gemv(const void* x, const void* qw, const void* scales,
                         const void* qz, const void* bias, void* y, int M,
                         int K, int N, int group, int x_dtype, int s_dtype,
                         void* stream) {
  if (M < 1 || M > MMAX || K % 8 || N % 8 || group % 8 || K % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == DT_F32 && s_dtype == DT_F32)
    launch<float, float>(x, qw, scales, qz, bias, y, M, K, N, group, st);
  else if (x_dtype == DT_F32 && s_dtype == DT_BF16)
    launch<float, __nv_bfloat16>(x, qw, scales, qz, bias, y, M, K, N, group,
                                 st);
  else if (x_dtype == DT_BF16 && s_dtype == DT_F32)
    launch<__nv_bfloat16, float>(x, qw, scales, qz, bias, y, M, K, N, group,
                                 st);
  else if (x_dtype == DT_BF16 && s_dtype == DT_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, qw, scales, qz, bias, y, M, K, N,
                                         group, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
