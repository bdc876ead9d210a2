// Fused W4A16 GEMM (OPT4GPTQ lane): y = x @ dequant(qweight) for M > 8.
//
// Replaces: repro/kernels/gptq_matmul.py::gptq_matmul, OPT4GPTQ branch ->
// _kernel_vmem (K-innermost grid, in-place dequant, fp32 accumulator, one
// writeback).
//
// Bound on the H100: operations at the main path's M (8 rows x a 512-token
// step = 4096): 2*M*K*N multiply-adds against ~K*N/2 weight bytes puts it
// far above the card's ~295 operations per byte.  At small M it is bytes.
//
// Design: a 128x128 output tile per block, 256 threads each owning an 8x8
// register micro-tile (64 fp32 accumulators), K walked innermost in steps
// of 32.  Per step the block stages a 128x32 x tile (as float32) and the
// matching 4 packed rows x 128 columns of qweight, which 256 threads unpack
// with unsigned shifts and dequantize in place — (q - z) * s with the scale
// and zero row taken per packed word as k / group, so any group that is a
// multiple of 8 works whatever its relation to the tile — into a 32x128
// float32 shared-memory tile.  The dequantized weight never leaves shared
// memory, and each output element is written back once.  Ragged M, N and
// K edges are masked in the kernel.  Arithmetic is fp32 FMA on the CUDA
// cores; the tensor-core (wgmma) version is later work.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int TM = 8, TN = 8;        // micro-tile per thread
constexpr int THREADS = 256;         // 16 x 16 threads
constexpr int PAD = 4;

template <typename TX, typename TS>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const TX* __restrict__ x, const int32_t* __restrict__ qw,
            const TS* __restrict__ scales, const int32_t* __restrict__ qz,
            TX* __restrict__ y, int M, int K, int N, int group) {
  __shared__ float As[BK][BM + PAD];   // x tile, k-major
  __shared__ float Bs[BK][BN + PAD];   // dequantized weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x: BM x BK values; neighbouring threads read neighbouring k
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    // weights: BK/8 packed rows x BN columns, dequantized into Bs
    for (int e = tid; e < (BK / 8) * BN; e += THREADS) {
      const int wr = e / BN, nn = e % BN;
      const int k = k0 + 8 * wr, n = n0 + nn;
      if (k < K && n < N) {
        const uint32_t word = (uint32_t)qw[(size_t)(k >> 3) * N + n];
        const int gi = k / group;
        const float s = to_f32(scales[(size_t)gi * N + n]);
        const float z = zero_point(qz + (size_t)gi * (N >> 3), n);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[8 * wr + i][nn] = (nibble(word, i) - z) * s;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[8 * wr + i][nn] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(size_t)m * N + n] = from_f32<TX>(acc[i][j]);
    }
  }
}

template <typename TX, typename TS>
void launch(const void* x, const void* qw, const void* scales, const void* qz,
            void* y, int M, int K, int N, int group, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM), block(THREADS);
  gemm_kernel<TX, TS><<<grid, block, 0, stream>>>(
      (const TX*)x, (const int32_t*)qw, (const TS*)scales,
      (const int32_t*)qz, (TX*)y, M, K, N, group);
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched).
extern "C" int gptq_matmul(const void* x, const void* qw, const void* scales,
                           const void* qz, void* y, int M, int K, int N,
                           int group, int x_dtype, int s_dtype,
                           void* stream) {
  if (M < 1 || K % 8 || N % 8 || group % 8 || K % group ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == DT_F32 && s_dtype == DT_F32)
    launch<float, float>(x, qw, scales, qz, y, M, K, N, group, st);
  else if (x_dtype == DT_F32 && s_dtype == DT_BF16)
    launch<float, __nv_bfloat16>(x, qw, scales, qz, y, M, K, N, group, st);
  else if (x_dtype == DT_BF16 && s_dtype == DT_F32)
    launch<__nv_bfloat16, float>(x, qw, scales, qz, y, M, K, N, group, st);
  else if (x_dtype == DT_BF16 && s_dtype == DT_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, qw, scales, qz, y, M, K, N, group,
                                         st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
