// The int8 x int8 -> int32 GEMM with one scalar rescale, for Hopper (sm_90a).
//
// Replaces int8_matmul_pallas of src/repro/kernels/int8_matmul.py: a (B, M, K)
// int8 against b (B, N, K) int8 (contraction-last, the layout the port holds
// every mantissa in), the exact int32 sum over all of K, then one float32
// multiply by the scalar scale 2^(sa + sb) -> y (B, M, N) f32.  The batch
// grid dimension serves the batched qbmm.
//
// Design.  The TPU kernel walks K on its sequential grid axis with the sum in
// VMEM scratch.  Here one block owns a 64 x 64 output tile and loops over K
// itself: each 64-wide slice of a and b is staged in shared memory (zero
// past the ragged edges: a zero mantissa adds nothing to an int32 sum, as
// the reference's zero padding) and contracted on the tensor cores through
// the warp-level wmma API (int8 16 x 16 x 16 fragments, int32 accumulators;
// four warps of 32 x 32).  The epilogue stores the int32 tile to shared
// memory, converts it with one rounding (__int2float_rn) and multiplies by
// the scale once (__fmul_rn): the plain version's arithmetic, so the two
// agree bit for bit; int32 addition is exact in any order, and the callers
// bound K * 127^2 below 2^31.  Blocks walk M fastest, so the b tile of an
// output column strip (the large operand: the LM head) is read from device
// memory about once.
//
// Bound on the H100: max(bytes, operations): M*K + N*K bytes in, 4*M*N out,
// over 3.35 TB/s, against 2*M*N*K int8 operations at 1979 TOP/s.  This
// first version uses neither wgmma nor TMA nor a pipelined ring of tiles:
// it is right first; fast is later work.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64;   // output tile
constexpr int WK = 16;            // fragment depth
constexpr int KC = 4;             // fragments per staged K slice
constexpr int BK = KC * WK;       // 64
constexpr int THREADS = 128;      // 4 warps, 2 x 2, 32 x 32 each

// One 16-byte chunk of row `row`, columns [k, k + 16), of a (rows, K) int8
// matrix into shared memory, zero past the edges.
template <bool VEC>
__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* __restrict__ src,
                                           int row, int rows, int k, int K) {
  if (VEC) {
    int4 v = make_int4(0, 0, 0, 0);
    if (row < rows && k < K) v = *reinterpret_cast<const int4*>(src + (size_t)row * K + k);
    *reinterpret_cast<int4*>(dst) = v;
  } else {
#pragma unroll
    for (int t = 0; t < WK; ++t)
      dst[t] = (row < rows && k + t < K) ? src[(size_t)row * K + k + t] : (int8_t)0;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const float* __restrict__ scale, float* __restrict__ y, int M, int N, int K) {
  // [k chunk][row][16]: every fragment starts on a 256-byte boundary
  __shared__ __align__(128) int8_t As[KC][BM][WK];
  __shared__ __align__(128) int8_t Bs[KC][BN][WK];
  __shared__ __align__(128) int Cs[BM][BN];

  const size_t z = blockIdx.z;
  a += z * M * K;
  b += z * N * K;
  y += z * M * N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = threadIdx.x; c < BM * KC; c += THREADS) {
      const int row = c / KC, kc = c % KC;
      load_chunk<VEC>(&As[kc][row][0], a, m0 + row, M, k0 + kc * WK, K);
      load_chunk<VEC>(&Bs[kc][row][0], b, n0 + row, N, k0 + kc * WK, K);
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[kc][wm + 16 * i][0], WK);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[kc][wn + 16 * j][0], WK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], BN, wmma::mem_row_major);
  __syncthreads();
  const float sc = *scale;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) y[(size_t)gm * N + gn] = __fmul_rn(__int2float_rn(Cs[r][c]), sc);
  }
}

}  // namespace

extern "C" {

// a (B,M,K) int8, b (B,N,K) int8, scale f32 scalar -> y (B,M,N) f32.
// M, N >= 1; B <= 65535; ceil(N / 64) <= 65535.
int repro_int8_matmul(const void* a, const void* b, const void* scale, void* y,
                      int B, int M, int N, int K, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, B);
  const bool vec = K % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ai = static_cast<const int8_t*>(a);
  const auto* bi = static_cast<const int8_t*>(b);
  const auto* sc = static_cast<const float*>(scale);
  auto* yo = static_cast<float*>(y);
  if (vec)
    int8_matmul_kernel<true><<<grid, THREADS, 0, s>>>(ai, bi, sc, yo, M, N, K);
  else
    int8_matmul_kernel<false><<<grid, THREADS, 0, s>>>(ai, bi, sc, yo, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
