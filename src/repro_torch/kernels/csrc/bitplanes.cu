// Bit-plane packing and unpacking for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package packs with jnp element-wise ops
// that XLA fuses (src/repro/core/bitplanes.py); the port's plain PyTorch
// version of the same arithmetic (core/bitplanes.py) runs five kernels a
// plane and took most of a pim.compile call on the card, so packing got
// kernels of its own.
//
// A plane holds one bit of every row: bit r % 32 of word r / 32 of plane j
// is bit j of row r.  Packing 32 rows is a transpose of a 32 x 32 bit
// matrix (rows in, one word a plane out); unpacking is the same transpose
// the other way.
//
// Bound on this card: bytes.  Packing reads n rows of a 1-, 2- or 4-byte
// carrier and writes nbits x ceil(n / 32) words; unpacking reads the planes
// and writes n int32.  Design:
//  * a lane owns one word (32 rows) and a warp a tile of 32 neighbouring
//    words, so a warp's access to one plane is 128 contiguous bytes: the
//    planes' side is coalesced without staging;
//  * the rows' side goes through the warp's slice of shared memory: the
//    warp moves its tile's rows between device memory and shared memory in
//    16-byte accesses in address order, and each lane takes or puts its own
//    32 rows there.  16-byte chunks are XOR-swizzled (chunk c at
//    c ^ ((c >> 3) & 7)) so that neither side conflicts on banks;
//  * the transpose runs in registers: 32-bit rows by five stages of masked
//    swaps (the 16- and 8-bit stages as byte permutes, about 300 logic ops
//    a word); 8-bit rows by four 8 x 8 transposes and two 4 x 4 byte
//    transposes (about 100), so int8 packing stays bound by bytes too;
//  * a tile that runs past n, or rows that do not start on 16 bytes (a
//    slice of a larger tensor), go one row at a time, rows past n as zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                // warps a block
constexpr int TILE_WORDS = 32;          // words a warp: one a lane
constexpr int TILE_ROWS = TILE_WORDS * 32;

__device__ __forceinline__ int swizzle(int chunk) { return chunk ^ ((chunk >> 3) & 7); }

// Rows i and i + S swap the bits of the columns j + S (row i) and j (row
// i + S), for every column j with (j & S) == 0: one stage of the transpose.
template <int S>
__device__ __forceinline__ void swap_stage(uint32_t (&a)[32], uint32_t low_columns) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i & S) continue;
    const uint32_t t = ((a[i] >> S) ^ a[i + S]) & low_columns;
    a[i + S] ^= t;
    a[i] ^= t << S;
  }
}

// 32 x 32 bit transpose: bit j of a[i] <-> bit i of a[j].
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // the 16-bit stage as byte permutes
    const uint32_t x = a[i], y = a[i + 16];
    a[i] = __byte_perm(x, y, 0x5410);
    a[i + 16] = __byte_perm(x, y, 0x7632);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {  // the 8-bit stage
    if (i & 8) continue;
    const uint32_t x = a[i], y = a[i + 8];
    a[i] = __byte_perm(x, y, 0x6240);
    a[i + 8] = __byte_perm(x, y, 0x7351);
  }
  swap_stage<4>(a, 0x0F0F0F0Fu);
  swap_stage<2>(a, 0x33333333u);
  swap_stage<1>(a, 0x55555555u);
}

// 8 x 8 bit transpose of the 64-bit value hi:lo: bit k of byte j <-> bit j
// of byte k.
__device__ __forceinline__ void transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// 4 x 4 byte transpose: byte j of w_g <-> byte g of w_j.
__device__ __forceinline__ void transpose4x4(uint32_t& w0, uint32_t& w1, uint32_t& w2, uint32_t& w3) {
  const uint32_t s0 = __byte_perm(w0, w1, 0x5140), s1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t s2 = __byte_perm(w2, w3, 0x5140), s3 = __byte_perm(w2, w3, 0x7362);
  w0 = __byte_perm(s0, s2, 0x5410);
  w1 = __byte_perm(s0, s2, 0x7632);
  w2 = __byte_perm(s1, s3, 0x5410);
  w3 = __byte_perm(s1, s3, 0x7632);
}

// 32 rows of 8 bits, r[k] holding rows 4k .. 4k + 3 in its bytes, become
// 8 planes: plane j in r[plane_reg(j)] ...
__device__ __forceinline__ constexpr int plane_reg(int j) { return j < 4 ? 2 * j : 2 * (j - 4) + 1; }

__device__ __forceinline__ void rows_to_planes8(uint32_t (&r)[8]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose8(r[2 * g], r[2 * g + 1]);  // rows 8g .. 8g + 7
  transpose4x4(r[0], r[2], r[4], r[6]);
  transpose4x4(r[1], r[3], r[5], r[7]);
}

// ... and back.
__device__ __forceinline__ void planes_to_rows8(uint32_t (&r)[8]) {
  transpose4x4(r[0], r[2], r[4], r[6]);
  transpose4x4(r[1], r[3], r[5], r[7]);
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose8(r[2 * g], r[2 * g + 1]);
}

template <int B> struct Carrier;
template <> struct Carrier<1> { using type = uint8_t; };
template <> struct Carrier<2> { using type = uint16_t; };
template <> struct Carrier<4> { using type = uint32_t; };

// Rows of a B-byte two's-complement carrier -> nbits planes, plane j at
// planes + j * row_stride.  Bits past 8 * B are the sign's, as a cast to
// int32 makes them.
template <int B>
__global__ void __launch_bounds__(WARPS * 32) bitplane_pack_kernel(
    const unsigned char* __restrict__ x, long long n, int nbits,
    uint32_t* __restrict__ planes, long long row_stride, bool aligned) {
  constexpr int CHUNKS = TILE_ROWS * B / 16;  // 16-byte chunks a tile
  constexpr int LANE_CHUNKS = CHUNKS / 32;
  __shared__ uint4 smem[WARPS][CHUNKS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  const long long row0 = tile * TILE_ROWS;
  if (row0 >= n) return;  // the whole warp
  uint4* s = smem[warp];

  if (aligned && row0 + TILE_ROWS <= n) {
    const uint4* src = reinterpret_cast<const uint4*>(x + row0 * B);
#pragma unroll
    for (int i = 0; i < LANE_CHUNKS; ++i) {
      const int c = i * 32 + lane;
      s[swizzle(c)] = src[c];
    }
  } else {
    using T = typename Carrier<B>::type;
    unsigned char* sb = reinterpret_cast<unsigned char*>(s);
    for (int q = lane; q < TILE_ROWS; q += 32) {
      const long long r = row0 + q;
      const int o = q * B;
      *reinterpret_cast<T*>(sb + swizzle(o >> 4) * 16 + (o & 15)) =
          r < n ? *reinterpret_cast<const T*>(x + r * B) : T(0);
    }
  }
  __syncwarp();

  uint32_t w[8 * B];  // this lane's 32 rows, as they lie in memory
#pragma unroll
  for (int k = 0; k < LANE_CHUNKS; ++k) {
    const uint4 c = s[swizzle(lane * LANE_CHUNKS + k)];
    w[4 * k] = c.x;
    w[4 * k + 1] = c.y;
    w[4 * k + 2] = c.z;
    w[4 * k + 3] = c.w;
  }

  const long long word = tile * TILE_WORDS + lane;
  if (word >= (n + 31) / 32) return;
  uint32_t* dst = planes + word;
  if constexpr (B == 1) {
    rows_to_planes8(w);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nbits) dst[j * row_stride] = w[plane_reg(j)];
    for (int j = 8; j < nbits; ++j) dst[j * row_stride] = w[plane_reg(7)];
  } else {
    uint32_t a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (B == 2) {
        a[i] = static_cast<uint32_t>(static_cast<int32_t>(
            static_cast<int16_t>(static_cast<uint16_t>(w[i / 2] >> (16 * (i & 1))))));
      } else {
        a[i] = w[i];
      }
    }
    transpose32(a);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < nbits) dst[j * row_stride] = a[j];
  }
}

// nbits planes (plane j at planes + j * row_stride) -> n int32 rows: the
// bits as they are, then shifted up by sign_shift and arithmetically back
// down (sign_shift = 32 - nbits sign-extends, 0 keeps the bits).  BYTES:
// nbits <= 8.
template <bool BYTES>
__global__ void __launch_bounds__(WARPS * 32) bitplane_unpack_kernel(
    const uint32_t* __restrict__ planes, long long row_stride, long long n, int nbits,
    int sign_shift, int32_t* __restrict__ out, bool aligned) {
  constexpr int CHUNKS = TILE_ROWS * 4 / 16;
  constexpr int LANE_CHUNKS = CHUNKS / 32;
  __shared__ uint4 smem[WARPS][CHUNKS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  const long long row0 = tile * TILE_ROWS;
  if (row0 >= n) return;  // the whole warp
  uint4* s = smem[warp];
  const long long word = tile * TILE_WORDS + lane;
  const bool live = word < (n + 31) / 32;
  const uint32_t* src = planes + word;

  uint32_t v[32];
  if constexpr (BYTES) {
    uint32_t r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[plane_reg(j)] = live && j < nbits ? src[j * row_stride] : 0u;
    planes_to_rows8(r);
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = (r[i / 4] >> (8 * (i & 3))) & 0xFFu;
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = live && j < nbits ? src[j * row_stride] : 0u;
    transpose32(v);
  }
#pragma unroll
  for (int k = 0; k < LANE_CHUNKS; ++k) {
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e[i] = static_cast<uint32_t>(static_cast<int32_t>(v[4 * k + i] << sign_shift) >> sign_shift);
    s[swizzle(lane * LANE_CHUNKS + k)] = make_uint4(e[0], e[1], e[2], e[3]);
  }
  __syncwarp();

  if (aligned && row0 + TILE_ROWS <= n) {
    uint4* dst = reinterpret_cast<uint4*>(out + row0);
#pragma unroll
    for (int i = 0; i < LANE_CHUNKS; ++i) {
      const int c = i * 32 + lane;
      dst[c] = s[swizzle(c)];
    }
  } else {
    const int32_t* sw = reinterpret_cast<const int32_t*>(s);
    for (int q = lane; q < TILE_ROWS; q += 32) {
      const long long r = row0 + q;
      if (r < n) out[r] = sw[swizzle(q >> 2) * 4 + (q & 3)];
    }
  }
}

long long blocks_for(long long n) {
  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  return (tiles + WARPS - 1) / WARPS;
}

}  // namespace

// Packs n rows of x (elem_bytes 1, 2 or 4) into nbits planes of
// ceil(n / 32) words, plane j at planes + j * row_stride words.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int bitplane_pack_launch(const void* x, int elem_bytes, long long n, int nbits,
                                    void* planes, long long row_stride, void* stream) {
  if (nbits < 1 || nbits > 32 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid((unsigned)blocks_for(n)), block(WARPS * 32);
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* xb = static_cast<const unsigned char*>(x);
  auto* p = static_cast<uint32_t*>(planes);
  switch (elem_bytes) {
    case 1: bitplane_pack_kernel<1><<<grid, block, 0, st>>>(xb, n, nbits, p, row_stride, aligned); break;
    case 2: bitplane_pack_kernel<2><<<grid, block, 0, st>>>(xb, n, nbits, p, row_stride, aligned); break;
    case 4: bitplane_pack_kernel<4><<<grid, block, 0, st>>>(xb, n, nbits, p, row_stride, aligned); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Unpacks nbits planes (plane j at planes + j * row_stride words) into n
// int32 rows, sign-extended from nbits when is_signed.
extern "C" int bitplane_unpack_launch(const void* planes, long long row_stride, long long n,
                                      int nbits, int is_signed, void* out, void* stream) {
  if (nbits < 1 || nbits > 32 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int sign_shift = is_signed ? 32 - nbits : 0;
  const dim3 grid((unsigned)blocks_for(n)), block(WARPS * 32);
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* p = static_cast<const uint32_t*>(planes);
  auto* o = static_cast<int32_t*>(out);
  if (nbits <= 8) {
    bitplane_unpack_kernel<true><<<grid, block, 0, st>>>(p, row_stride, n, nbits, sign_shift, o, aligned);
  } else {
    bitplane_unpack_kernel<false><<<grid, block, 0, st>>>(p, row_stride, n, nbits, sign_shift, o, aligned);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bitplane_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
