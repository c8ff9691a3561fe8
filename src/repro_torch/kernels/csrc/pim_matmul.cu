// Batched matrix product for Hopper (sm_90a): [G,M,K] @ [G,K,N] -> [G,M,N].
//
// Replaces the TPU kernel `_mm_kernel` (driven by `matmul`) in
// src/repro/kernels/pim_matmul.py:31: the MatPIM-schedule blocked matmul.
// Each output element is a float32 sum of a[g,m,k] * b[g,k,n] over k,
// rounded once to the output type (float32, or bfloat16 round-to-nearest-
// even).  A bf16 x bf16 product is exact in float32, so the tensor cores'
// bf16 products with a float32 accumulator keep that contract.  No TF32
// anywhere: every float32 variant is plain FP32 FMA.
//
// Bound on this card.  A batch of n x n products moves 3 n^2 elements and
// does 2 n^3 FLOPs.  In float32 the FP32 FMA rate (66.9 TFLOP/s at
// 1980 MHz) against 3.35 TB/s puts the turn at n = 120: below it the call is
// bound by bytes, above by FP32 FMA issue.  In bf16 the tensor cores (989
// TFLOP/s) leave every Fig 5 size (n <= 512) bound by bytes.
//
// Variants, one kernel each, picked by pim_matmul.plan() from the shape and
// type and passed in by number; a variant refuses a shape it does not take.
//   0 general       any accepted shape, both types: one block owns one
//                   (16 R)^2 output tile of one batch entry, R x R register
//                   tile a thread, 16-deep K stages, masked edges (R = 1, 2
//                   or 4 by the larger of M and N).
//   1 f32_small     M = K = N in {16, 32, 64} (bound by bytes): a persistent
//                   block walks groups of 4096 / n^2 whole entries, two
//                   stages: B by 16-byte cp.async, A by float4 loads held in
//                   registers and stored transposed; 4 x 4 outputs a thread.
//   2 f32_simt128   M, N multiples of 128, K of 8 (bound by FP32 FMA): a
//                   128 x 128 block tile, 8 x 8 outputs a thread split in
//                   four 4 x 4 quadrants so every shared read is a
//                   conflict-free float4, A transposed in shared memory,
//                   8-deep K stages double-buffered (B by cp.async, A by
//                   float4 loads in flight across the FMAs).
//   3 bf16_mma      M = K = N in {16, 32}, smaller than wgmma's 64 rows: one
//                   warp per batch entry, mma.sync m16n8k16 on ldmatrix
//                   fragments (.trans for B, which arrives [K, N]), entries
//                   loaded by 16-byte cp.async two ahead.
//   4 bf16_wgmma64  M, N multiples of 64, K of 64 (and 5 bf16_wgmma128: M, N
//                   multiples of 128): wgmma.mma_async m64nNk16 on operands
//                   that TMA brings into a ring of 128-byte-swizzled shared
//                   stages tracked by mbarriers.  B stays [K, N]: its
//                   descriptor is MN-major and the instruction's
//                   transpose-B flag reads it as is.  A persistent grid
//                   walks the output tiles, so the copies of the next tile
//                   are in flight during a tile's last products and its
//                   epilogue, which rounds the product into the stage just
//                   freed (swizzled) and writes it with a TMA store.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// ---------------------------------------------------------------- general

constexpr int GEN_THREADS = 256;  // 16 x 16
constexpr int GEN_BK = 16;        // K depth of one shared-memory stage

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
__global__ void __launch_bounds__(GEN_THREADS) mm_general(
    const T* __restrict__ a,  // [G, M, K]
    const T* __restrict__ b,  // [G, K, N]
    T* __restrict__ c,        // [G, M, N]
    int M, int K, int N, int tiles_m, int tiles_n) {
  constexpr int TILE = 16 * R;      // output tile side
  constexpr int APAD = TILE + 4;    // padded row of the transposed A stage
  __shared__ __align__(16) float As[GEN_BK][APAD];  // As[k][m]
  __shared__ __align__(16) float Bs[GEN_BK][TILE];  // Bs[k][n]

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

  for (int k0 = 0; k0 < K; k0 += GEN_BK) {
    // A stage: TILE rows x GEN_BK columns, R elements a thread; neighbouring
    // threads read neighbouring k (coalesced), stored transposed.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int idx = t + i * GEN_THREADS;
      const int row = idx / GEN_BK, kk = idx % GEN_BK;
      const int m = m0 + row, k = k0 + kk;
      As[kk][row] = (m < M && k < K) ? to_float(ag[static_cast<long long>(m) * K + k]) : 0.f;
    }
    // B stage: GEN_BK rows x TILE columns; neighbouring threads read
    // neighbouring n.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int idx = t + i * GEN_THREADS;
      const int kk = idx / TILE, col = idx % TILE;
      const int k = k0 + kk, n = n0 + col;
      Bs[kk][col] = (k < K && n < N) ? to_float(bg[static_cast<long long>(k) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEN_BK; ++kk) {
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

template <typename T, int R>
cudaError_t launch_general_r(const void* a, const void* b, void* c, long long G, int M,
                             int K, int N, cudaStream_t stream) {
  const int tile = 16 * R;
  const int tiles_m = (M + tile - 1) / tile, tiles_n = (N + tile - 1) / tile;
  const long long blocks = G * tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mm_general<T, R><<<static_cast<unsigned>(blocks), GEN_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N, tiles_m, tiles_n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_general(const void* a, const void* b, void* c, long long G, int M,
                           int K, int N, cudaStream_t stream) {
  const int d = M > N ? M : N;
  if (d <= 16) return launch_general_r<T, 1>(a, b, c, G, M, K, N, stream);
  if (d <= 32) return launch_general_r<T, 2>(a, b, c, G, M, K, N, stream);
  return launch_general_r<T, 4>(a, b, c, G, M, K, N, stream);
}

// Blocks for a persistent grid: what fits on the card at once, at most
// `work` (one block per unit of work).
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem, long long work,
                              int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(work < cap ? work : cap);
  return cudaSuccess;
}

// ------------------------------------------------------------- f32_small

constexpr int SMALL_THREADS = 256;

// Shared-memory layout of one stage of f32_small<S>: E = 4096 / S^2
// entries; A transposed as [e][k][m] with rows of S + 4 and entries padded
// by 16 floats, B as [e][k][n] with entries padded by 16 floats, so the
// float4 reads of a warp fall in distinct banks.
template <int S>
struct SmallLayout {
  static constexpr int E = 4096 / (S * S);          // entries a stage
  static constexpr int A_ROW = S + 4;
  static constexpr int A_ENTRY = S * A_ROW + 16;
  static constexpr int B_ENTRY = S * S + 16;
  static constexpr int STAGE = E * (A_ENTRY + B_ENTRY);  // floats
  static constexpr int CHUNKS = E * S * S / 4 / SMALL_THREADS;  // float4 a thread, per operand
};

template <int S>
__global__ void __launch_bounds__(SMALL_THREADS) mm_f32_small(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
    long long G) {
  using L = SmallLayout<S>;
  static_assert(L::CHUNKS == 4, "4096 floats a stage and operand");
  extern __shared__ __align__(16) float sm[];  // [2][STAGE]
  const int t = threadIdx.x;
  constexpr int TPE = (S / 4) * (S / 4);  // threads an entry
  const int e_own = t / TPE, tx = (t % TPE) % (S / 4), ty = (t % TPE) / (S / 4);
  const long long groups = (G + L::E - 1) / L::E;

  float4 areg[L::CHUNKS];
  // Issue the loads of entry group `grp` into stage `st`: B by cp.async,
  // A into registers (stored transposed by store_a after the FMAs).
  auto load = [&](long long grp, int st) {
    float* Bs = sm + st * L::STAGE + L::E * L::A_ENTRY;
#pragma unroll
    for (int i = 0; i < L::CHUNKS; ++i) {
      const int q = t + i * SMALL_THREADS;  // float4 index inside the group
      const int e = q / (S * S / 4), r = q % (S * S / 4);
      const long long ge = grp * L::E + e;
      const int row = r / (S / 4), col = (r % (S / 4)) * 4;
      if (ge < G) {
        const long long off = ge * S * S + row * S + col;
        areg[i] = *reinterpret_cast<const float4*>(a + off);
        cp_async16(Bs + e * L::B_ENTRY + row * S + col, b + off);
      } else {
        areg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(Bs + e * L::B_ENTRY + row * S + col) = areg[i];
      }
    }
    cp_async_commit();
  };
  auto store_a = [&](int st) {
    float* As = sm + st * L::STAGE;
#pragma unroll
    for (int i = 0; i < L::CHUNKS; ++i) {
      const int q = t + i * SMALL_THREADS;
      const int e = q / (S * S / 4), r = q % (S * S / 4);
      const int m = r / (S / 4), k = (r % (S / 4)) * 4;
      float* dst = As + e * L::A_ENTRY + k * L::A_ROW + m;
      dst[0] = areg[i].x;
      dst[L::A_ROW] = areg[i].y;
      dst[2 * L::A_ROW] = areg[i].z;
      dst[3 * L::A_ROW] = areg[i].w;
    }
  };

  long long grp = blockIdx.x;
  if (grp >= groups) return;
  load(grp, 0);
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int st = 0; grp < groups; grp += gridDim.x, st ^= 1) {
    const long long next = grp + gridDim.x;
    if (next < groups) load(next, st ^ 1);
    const float* As = sm + st * L::STAGE + e_own * L::A_ENTRY + ty * 4;
    const float* Bs = sm + st * L::STAGE + L::E * L::A_ENTRY + e_own * L::B_ENTRY + tx * 4;
    float acc[4][4] = {};
#pragma unroll 16
    for (int k = 0; k < S; ++k) {
      fma4x4(acc, *reinterpret_cast<const float4*>(As + k * L::A_ROW),
             *reinterpret_cast<const float4*>(Bs + k * S));
    }
    const long long ge = grp * L::E + e_own;
    if (ge < G) {
      float* cg = c + ge * S * S + (ty * 4) * S + tx * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(cg + i * S) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    if (next < groups) {
      store_a(st ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }
}

template <int S>
cudaError_t launch_f32_small(const void* a, const void* b, void* c, long long G,
                             cudaStream_t stream) {
  const size_t smem = 2 * SmallLayout<S>::STAGE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mm_f32_small<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int blocks = 0;
  const long long groups = (G + SmallLayout<S>::E - 1) / SmallLayout<S>::E;
  if (err == cudaSuccess)
    err = persistent_blocks(mm_f32_small<S>, SMALL_THREADS, smem, groups, &blocks);
  if (err != cudaSuccess) return err;
  mm_f32_small<S><<<blocks, SMALL_THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), G);
  return cudaGetLastError();
}

// ----------------------------------------------------------- f32_simt128

constexpr int S128_THREADS = 256;  // 16 x 16, 8 x 8 outputs each
constexpr int S128_TILE = 128;
constexpr int S128_BK = 8;
constexpr int S128_APAD = 4;  // the transposed A rows are 132 floats

__global__ void __launch_bounds__(S128_THREADS, 2) mm_f32_simt128(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
    int M, int K, int N, int tiles_m, int tiles_n) {
  __shared__ __align__(16) float As[2][S128_BK][S128_TILE + S128_APAD];  // As[k][m]
  __shared__ __align__(16) float Bs[2][S128_BK][S128_TILE];               // Bs[k][n]

  long long blk = blockIdx.x;
  const int tn = static_cast<int>(blk % tiles_n);
  blk /= tiles_n;
  const int tm = static_cast<int>(blk % tiles_m);
  const long long g = blk / tiles_m;
  const float* ag = a + (g * M + tm * S128_TILE) * static_cast<long long>(K);
  const float* bg = b + g * K * static_cast<long long>(N) + tn * S128_TILE;

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  // Loads, LOADS float4 a thread and operand: A row (t + i * 256) / (BK / 4),
  // k 4 * ((t + i * 256) % (BK / 4)); B row (t + i * 256) / 32, n 4 * (t % 32).
  constexpr int LOADS = S128_BK / 8;
  const float* a_src[LOADS];
  const float* b_src[LOADS];
  int a_row[LOADS], a_k[LOADS], b_row[LOADS];
  const int b_col = (t % 32) * 4;
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int q = t + i * S128_THREADS;
    a_row[i] = q / (S128_BK / 4);
    a_k[i] = (q % (S128_BK / 4)) * 4;
    b_row[i] = q / 32;
    a_src[i] = ag + static_cast<long long>(a_row[i]) * K + a_k[i];
    b_src[i] = bg + static_cast<long long>(b_row[i]) * N + b_col;
  }

  float4 areg[LOADS];
  auto load = [&](int st, long long k0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      areg[i] = *reinterpret_cast<const float4*>(a_src[i] + k0);
      cp_async16(&Bs[st][b_row[i]][b_col], b_src[i] + k0 * N);
    }
    cp_async_commit();
  };
  auto store_a = [&](int st) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      As[st][a_k[i] + 0][a_row[i]] = areg[i].x;
      As[st][a_k[i] + 1][a_row[i]] = areg[i].y;
      As[st][a_k[i] + 2][a_row[i]] = areg[i].z;
      As[st][a_k[i] + 3][a_row[i]] = areg[i].w;
    }
  };

  float acc[2][2][4][4] = {};  // [row half][col half][4][4]
  load(0, 0);
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();

  const int nk = K / S128_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load(st ^ 1, static_cast<long long>(kt + 1) * S128_BK);
#pragma unroll
    for (int kk = 0; kk < S128_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][kk][64 + tx * 4]);
      fma4x4(acc[0][0], a0, b0);
      fma4x4(acc[0][1], a0, b1);
      fma4x4(acc[1][0], a1, b0);
      fma4x4(acc[1][1], a1, b1);
    }
    if (more) {
      store_a(st ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  float* cg = c + (g * M + tm * S128_TILE) * static_cast<long long>(N) + tn * S128_TILE;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = cg + static_cast<long long>(h * 64 + ty * 4 + i) * N;
#pragma unroll
      for (int w = 0; w < 2; ++w)
        *reinterpret_cast<float4*>(row + w * 64 + tx * 4) =
            make_float4(acc[h][w][i][0], acc[h][w][i][1], acc[h][w][i][2], acc[h][w][i][3]);
    }
}

cudaError_t launch_f32_simt128(const void* a, const void* b, void* c, long long G, int M,
                               int K, int N, cudaStream_t stream) {
  const int tiles_m = M / S128_TILE, tiles_n = N / S128_TILE;
  const long long blocks = G * tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mm_f32_simt128<<<static_cast<unsigned>(blocks), S128_THREADS, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c),
      M, K, N, tiles_m, tiles_n);
  return cudaGetLastError();
}

// -------------------------------------------------------------- bf16_mma

constexpr int MMA_WARPS = 4;
constexpr int MMA_STAGES = 3;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp per batch entry of S x S (S = 16 or 32); rows padded to S + 8
// elements so each ldmatrix phase hits distinct banks.
template <int S>
__global__ void __launch_bounds__(32 * MMA_WARPS) mm_bf16_mma(
    const bf16* __restrict__ a, const bf16* __restrict__ b, bf16* __restrict__ c, long long G) {
  constexpr int ROW = S + 8;                 // elements a padded row
  constexpr int OPERAND = S * ROW;           // elements an operand
  constexpr int STAGE = 2 * OPERAND;         // A then B
  constexpr int CHUNKS = S * S / 8 / 32;     // 16-byte copies a lane, per operand
  constexpr int MT = S / 16, NT = S / 8, KT = S / 16;
  extern __shared__ __align__(16) bf16 smb[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* mine = smb + warp * MMA_STAGES * STAGE;
  const long long stride = static_cast<long long>(gridDim.x) * MMA_WARPS;
  const long long first = static_cast<long long>(blockIdx.x) * MMA_WARPS + warp;

  auto load = [&](long long e, int st) {
    if (e < G) {
      bf16* dst = mine + st * STAGE;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int q = lane + 32 * i;
        const int row = q / (S / 8), col = (q % (S / 8)) * 8;
        cp_async16(dst + row * ROW + col, a + e * S * S + q * 8);
        cp_async16(dst + OPERAND + row * ROW + col, b + e * S * S + q * 8);
      }
    }
    cp_async_commit();  // one group a call, empty or not, for the wait count
  };

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) load(first + s * stride, s);
  int st = 0;
  for (long long e = first; e < G; e += stride) {
    load(e + (MMA_STAGES - 1) * stride, (st + MMA_STAGES - 1) % MMA_STAGES);
    cp_async_wait<MMA_STAGES - 1>();
    __syncwarp();
    const bf16* As = mine + st * STAGE;
    const bf16* Bs = As + OPERAND;
    float acc[MT][NT][4] = {};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t bfrag[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4_trans(bfrag[np], Bs + (kt * 16 + lane % 16) * ROW + np * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t afrag[4];
        ldmatrix_x4(afrag, As + (mt * 16 + lane % 16) * ROW + kt * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], afrag, bfrag[nt / 2][(nt % 2) * 2], bfrag[nt / 2][(nt % 2) * 2 + 1]);
      }
    }
    bf16* cg = c + e * S * S;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = mt * 16 + lane / 4, col = nt * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(cg + row * S + col) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(cg + (row + 8) * S + col) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncwarp();  // every lane is done with this stage before it is refilled
    st = (st + 1) % MMA_STAGES;
  }
  cp_async_wait<0>();
}

template <int S>
cudaError_t launch_bf16_mma(const void* a, const void* b, void* c, long long G,
                            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(MMA_WARPS) * MMA_STAGES * 2 * S * (S + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      mm_bf16_mma<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = persistent_blocks(mm_bf16_mma<S>, 32 * MMA_WARPS, smem,
                            (G + MMA_WARPS - 1) / MMA_WARPS, &blocks);
  if (err != cudaSuccess) return err;
  mm_bf16_mma<S><<<blocks, 32 * MMA_WARPS, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c), G);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16_wgmma

constexpr int WG_BK = 64;            // K depth of a stage: one 128-byte swizzle row
constexpr int SWIZZLE_ROW = 128;     // bytes
constexpr int SWIZZLE_ATOM = 1024;   // 8 rows of 128 bytes

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of `parity` to complete; a copy that never lands
// (some 10^8 polls, seconds) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 27)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the bulk stores issued by this thread have read their shared
// memory (reads = true) or completed.
template <bool reads>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (reads) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x N] += A[64 x 16] (K-major) * B[16 x N] (MN-major: transpose-B = 1).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_m64n64k16(d, da, db);
  else wgmma_m64n128k16(d, da, db);
}

// A stage holds A as [BM rows][64 k] (128-byte rows, swizzled) and B as
// BN / 64 blocks of [64 k][64 n]; one warpgroup per 64 rows of the tile.
template <int BM, int BN>
struct WgmmaLayout {
  static constexpr int THREADS = BM * 2;  // 128 a warpgroup
  static constexpr int STAGES = BM == 128 ? 3 : 4;
  static constexpr int A_BYTES = BM * SWIZZLE_ROW;
  static constexpr int B_BLOCK = WG_BK * SWIZZLE_ROW;  // one 64-column block of B
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_BLOCK;
  static constexpr size_t SMEM = STAGES * STAGE_BYTES + SWIZZLE_ATOM;  // + alignment slack
  static_assert(BM * BN * 2 <= STAGE_BYTES, "the bf16 product tile fits a freed stage");
};

// The body of the bf16_wgmma kernels, one per tile (below); the tensor maps
// are the kernel's __grid_constant__ parameters.
template <int BM, int BN>
__device__ __forceinline__ void bf16_wgmma_tiles(
    const CUtensorMap& map_a,  // [G, M, K], box [1, BM, 64]
    const CUtensorMap& map_b,  // [G, K, N], box [1, 64, 64]
    const CUtensorMap& map_c,  // [G, M, N], box [1, BM, 64]
    int M, int K, int N, long long tiles) {
  using L = WgmmaLayout<BM, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[L::STAGES];
  unsigned char* smem = smem_raw + ((SWIZZLE_ATOM - (smem_addr(smem_raw) % SWIZZLE_ATOM)) % SWIZZLE_ATOM);

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int tiles_m = M / BM, tiles_n = N / BN, nk = K / WG_BK;
  if (blockIdx.x >= tiles) return;
  const long long my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long steps = my_tiles * nk;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Step s: k-slice s % nk of this block's tile s / nk, into stage s % STAGES.
  auto issue = [&](long long s) {
    const long long tile = blockIdx.x + (s / nk) * gridDim.x;
    const int kt = static_cast<int>(s % nk);
    const int tn = static_cast<int>(tile % tiles_n);
    const int tm = static_cast<int>((tile / tiles_n) % tiles_m);
    const int g = static_cast<int>(tile / (static_cast<long long>(tiles_n) * tiles_m));
    const int st = static_cast<int>(s % L::STAGES);
    unsigned char* dst = smem + st * L::STAGE_BYTES;
    bulk_wait<true>();  // a tile's store out of this stage has read it
    mbar_expect_tx(&full[st], L::STAGE_BYTES);
    tma_load_3d(dst, &map_a, &full[st], kt * WG_BK, tm * BM, g);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_3d(dst + L::A_BYTES + j * L::B_BLOCK, &map_b, &full[st], tn * BN + j * 64,
                  kt * WG_BK, g);
  };

  if (tid == 0)
    for (long long s = 0; s < L::STAGES - 1 && s < steps; ++s) issue(s);

  float acc[BN / 2];
  for (long long s = 0; s < steps; ++s) {
    const int kt = static_cast<int>(s % nk);
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    const int st = static_cast<int>(s % L::STAGES);
    mbar_wait(&full[st], static_cast<uint32_t>((s / L::STAGES) & 1));
    const unsigned char* a_tile = smem + st * L::STAGE_BYTES + wg * 64 * SWIZZLE_ROW;
    const unsigned char* b_tile = smem + st * L::STAGE_BYTES + L::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: K-major, the 16-deep slice 32 bytes into each swizzled row; rows
      // in 8-row atoms of 1024 bytes.  B: MN-major, the slice 16 rows down;
      // 8-row atoms of 1024 bytes along K, 64-column blocks B_BLOCK apart.
      const uint64_t da = smem_desc(a_tile + kk * 32, 16, SWIZZLE_ATOM);
      const uint64_t db = smem_desc(b_tile + kk * 16 * SWIZZLE_ROW, L::B_BLOCK, SWIZZLE_ATOM);
      wgmma_tile<BN>(acc, da, db);
    }
    wgmma_commit();
    // The products of step s - 1 are done, so its stage takes the copy of
    // step s - 1 + STAGES; step s's products run on meanwhile.
    wgmma_wait<1>();
    __syncthreads();
    if (tid == 0 && s + L::STAGES - 1 < steps) issue(s + L::STAGES - 1);
    if (kt == nk - 1) {
      wgmma_wait<0>();
      __syncthreads();  // every warpgroup's products are done with this stage
      // Epilogue: the product, rounded to bf16, into the stage just freed,
      // in the 128-byte-swizzled [BN / 64][BM][64] layout a TMA store reads
      // (16-byte chunk index XOR row % 8), then one thread stores the tile.
      unsigned char* c_tile = smem + st * L::STAGE_BYTES;
      const int row = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          unsigned char* dst = c_tile + (q / 8) * (BM * SWIZZLE_ROW) + r * SWIZZLE_ROW +
                               (((q % 8) ^ (r % 8)) * 16) + (lane % 4) * 4;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        const long long tile = blockIdx.x + (s / nk) * gridDim.x;
        const int tn = static_cast<int>(tile % tiles_n);
        const int tm = static_cast<int>((tile / tiles_n) % tiles_m);
        const int g = static_cast<int>(tile / (static_cast<long long>(tiles_n) * tiles_m));
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_store_3d(&map_c, c_tile + j * (BM * SWIZZLE_ROW), tn * BN + j * 64, tm * BM, g);
      }
    }
  }
  if (tid == 0) bulk_wait<false>();
}

__global__ void __launch_bounds__(WgmmaLayout<64, 64>::THREADS) mm_bf16_wgmma64(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, int M, int K, int N, long long tiles) {
  bf16_wgmma_tiles<64, 64>(map_a, map_b, map_c, M, K, N, tiles);
}
__global__ void __launch_bounds__(WgmmaLayout<128, 128>::THREADS) mm_bf16_wgmma128(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, int M, int K, int N, long long tiles) {
  bf16_wgmma_tiles<128, 128>(map_a, map_b, map_c, M, K, N, tiles);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so the
// library links without -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 tensor map over [depth, rows, cols] (cols contiguous), box
// [1, box_rows, 64], 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* base, long long depth, int rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * sizeof(bf16),
                                 static_cast<cuuint64_t>(rows) * cols * sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, typename Kernel>
cudaError_t launch_bf16_wgmma(Kernel kernel, const void* a, const void* b, void* c, long long G,
                              int M, int K, int N, cudaStream_t stream) {
  using L = WgmmaLayout<BM, BN>;
  CUtensorMap map_a, map_b, map_c;
  if (!encode_map(&map_a, a, G, M, K, BM) || !encode_map(&map_b, b, G, K, N, WG_BK) ||
      !encode_map(&map_c, c, G, M, N, BM))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  const long long tiles = G * (M / BM) * (N / BN);
  int blocks = 0;
  if (err == cudaSuccess) err = persistent_blocks(kernel, L::THREADS, L::SMEM, tiles, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, L::THREADS, L::SMEM, stream>>>(map_a, map_b, map_c, M, K, N, tiles);
  return cudaGetLastError();
}

enum Variant {
  GENERAL = 0, F32_SMALL = 1, F32_SIMT128 = 2, BF16_MMA = 3, BF16_WGMMA64 = 4, BF16_WGMMA128 = 5
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; variant: the Variant numbering above
// (pim_matmul.VARIANTS).  Returns the launch's cudaError_t (0 on success),
// cudaErrorInvalidValue for a variant that does not take the type or shape;
// the kernel runs asynchronously on `stream`.  Operands are contiguous and
// 16-byte aligned.
extern "C" int pim_matmul_launch(const void* a, const void* b, void* c, int dtype, int variant,
                                 long long G, int M, int K, int N, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0 || K <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0, bf = dtype == 1;
  const bool square = M == K && K == N;
  cudaError_t err = cudaErrorInvalidValue;
  switch (variant) {
    case GENERAL:
      if (f32) err = launch_general<float>(a, b, c, G, M, K, N, s);
      if (bf) err = launch_general<bf16>(a, b, c, G, M, K, N, s);
      break;
    case F32_SMALL:
      if (f32 && square && M == 16) err = launch_f32_small<16>(a, b, c, G, s);
      if (f32 && square && M == 32) err = launch_f32_small<32>(a, b, c, G, s);
      if (f32 && square && M == 64) err = launch_f32_small<64>(a, b, c, G, s);
      break;
    case F32_SIMT128:
      if (f32 && M % S128_TILE == 0 && N % S128_TILE == 0 && K % S128_BK == 0)
        err = launch_f32_simt128(a, b, c, G, M, K, N, s);
      break;
    case BF16_MMA:
      if (bf && square && M == 16) err = launch_bf16_mma<16>(a, b, c, G, s);
      if (bf && square && M == 32) err = launch_bf16_mma<32>(a, b, c, G, s);
      break;
    case BF16_WGMMA64:
      if (bf && M % 64 == 0 && N % 64 == 0 && K % WG_BK == 0)
        err = launch_bf16_wgmma<64, 64>(mm_bf16_wgmma64, a, b, c, G, M, K, N, s);
      break;
    case BF16_WGMMA128:
      if (bf && M % 128 == 0 && N % 128 == 0 && K % WG_BK == 0)
        err = launch_bf16_wgmma<128, 128>(mm_bf16_wgmma128, a, b, c, G, M, K, N, s);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

extern "C" const char* pim_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
