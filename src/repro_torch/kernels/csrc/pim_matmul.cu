// Batched matrix product for Hopper (sm_90a): [G,M,K] @ [G,K,N] -> [G,M,N].
//
// Replaces the TPU kernel `_mm_kernel` (driven by `matmul`) in
// src/repro/kernels/pim_matmul.py:31: the MatPIM-schedule blocked matmul.
// Each output element is a float32 sum of a[g,m,k] * b[g,k,n] over k,
// rounded once to the output type (float32, or bfloat16 with
// __float2bfloat16_rn).  Inputs are float32 or bfloat16; a bfloat16 value
// is widened to float32 before the FMA (a bf16 x bf16 product is exact in
// float32).  No TF32 anywhere: the float32 path is plain FP32 FMA, so it
// meets the reference's float32 tolerance.
//
// Bound on this card.  A batch of n x n products moves 3 n^2 words and does
// 2 n^3 FLOPs, so its reuse is n/6 FLOP per byte in float32.  The H100's
// FP32 balance is 67e12 / 3.35e12 = 20 FLOP/byte: below n = 120 the call is
// bound by device-memory bytes, above it by FP32 FMA throughput (this
// kernel does not use the tensor cores, so in bfloat16 too its own ceiling
// is the FP32 rate, while the card's bf16 bound is the tensor cores').
//
// Design.  One block of 256 threads (16 x 16) owns one output tile of one
// batch entry; (batch, tile row, tile column) is flattened into blockIdx.x,
// because Fig 5's small sizes need G = 262 144 batch entries, above the
// 65 535 limit of gridDim.y/z.  Each thread accumulates an R x R register
// tile of contiguous rows and columns (tile side 16 R): R = 4 (64 x 64) for
// the compute-bound sizes, R = 2 or 1 when both M and N are at most 32 or
// 16, so small matrices do not idle most of a block.  The K loop stages
// 16-deep slices of A (transposed, padded against bank conflicts) and B in
// shared memory as float32; per k each thread reads R values of each from
// shared memory (one 16-byte load each at R = 4) for R^2 FMAs.  Every
// global load and store is masked, so any M, N, K are taken (17, 33, 384).
// Not yet done: double buffering (cp.async/TMA), and wgmma for bfloat16.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BK = 16;        // K depth of one shared-memory stage

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// R contiguous floats from shared memory (one vector load where aligned).
template <int R>
__device__ __forceinline__ void load_row(float (&dst)[R], const float* src) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = src[0];
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS) pim_matmul_kernel(
    const T* __restrict__ a,  // [G, M, K]
    const T* __restrict__ b,  // [G, K, N]
    T* __restrict__ c,        // [G, M, N]
    int M, int K, int N, int tiles_m, int tiles_n) {
  constexpr int TILE = 16 * R;      // output tile side
  constexpr int APAD = TILE + 4;    // padded row of the transposed A stage
  __shared__ __align__(16) float As[BK][APAD];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][TILE];  // Bs[k][n]

  long long blk = blockIdx.x;
  const int tn = static_cast<int>(blk % tiles_n);
  blk /= tiles_n;
  const int tm = static_cast<int>(blk % tiles_m);
  const long long g = blk / tiles_m;
  const int m0 = tm * TILE, n0 = tn * TILE;

  const T* ag = a + g * M * static_cast<long long>(K);
  const T* bg = b + g * K * static_cast<long long>(N);
  T* cg = c + g * M * static_cast<long long>(N);

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A stage: TILE rows x BK columns, R elements a thread; neighbouring
    // threads read neighbouring k (coalesced), stored transposed.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int idx = t + i * THREADS;
      const int row = idx / BK, kk = idx % BK;
      const int m = m0 + row, k = k0 + kk;
      As[kk][row] = (m < M && k < K) ? to_float(ag[static_cast<long long>(m) * K + k]) : 0.f;
    }
    // B stage: BK rows x TILE columns; neighbouring threads read
    // neighbouring n.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int idx = t + i * THREADS;
      const int kk = idx / TILE, col = idx % TILE;
      const int k = k0 + kk, n = n0 + col;
      Bs[kk][col] = (k < K && n < N) ? to_float(bg[static_cast<long long>(k) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[R], bv[R];
      load_row<R>(av, &As[kk][ty * R]);
      load_row<R>(bv, &Bs[kk][tx * R]);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + ty * R + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = n0 + tx * R + j;
      if (n < N) store(cg + static_cast<long long>(m) * N + n, acc[i][j]);
    }
  }
}

// Register tile side per thread: 1, 2 or 4 by the larger of M and N.
int pick_r(int M, int N) {
  const int d = M > N ? M : N;
  return d <= 16 ? 1 : d <= 32 ? 2 : 4;
}

template <typename T, int R>
cudaError_t launch(const void* a, const void* b, void* c, long long G, int M,
                   int K, int N, cudaStream_t stream) {
  const int tile = 16 * R;
  const int tiles_m = (M + tile - 1) / tile, tiles_n = (N + tile - 1) / tile;
  const long long blocks = G * tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  pim_matmul_kernel<T, R><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N, tiles_m, tiles_n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* a, const void* b, void* c, long long G, int M,
                     int K, int N, cudaStream_t stream) {
  switch (pick_r(M, N)) {
    case 1: return launch<T, 1>(a, b, c, G, M, K, N, stream);
    case 2: return launch<T, 2>(a, b, c, G, M, K, N, stream);
    default: return launch<T, 4>(a, b, c, G, M, K, N, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int pim_matmul_launch(const void* a, const void* b, void* c, int dtype,
                                 long long G, int M, int K, int N, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_t<float>(a, b, c, G, M, K, N, s)
      : dtype == 1 ? launch_t<__nv_bfloat16>(a, b, c, G, M, K, N, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* pim_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
