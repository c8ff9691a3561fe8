// Loop-mode bit-serial gate-schedule executor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (driven by `_run`) in
// src/repro/kernels/pim_bitserial.py: execute any column-allocated PIM gate
// schedule over packed bit-planes.  Each 32-bit word holds one bit of 32
// elements; a schedule row (op, a, b, c, o) overwrites column o with
// NOR / MAJ3 / NOT / INIT0 / INIT1 / COPY of whole columns.
//
// Bound on this card.  Each gate is one 32-bit logic op per word, so the
// work is gates x W ops on the INT32 lanes, against (n_in + n_out) x W x 4 B
// of boundary planes: the fused f32 MAC (12 968 gates, 128 boundary planes)
// is bound by logic throughput (0.41 ms at 2^19 words).  A kernel that
// keeps the state in shared memory cannot reach that: every gate costs up
// to three shared loads and a store per word, so shared-memory bandwidth
// and issue set its floor (about 2.4 ms for the memristive f32 MAC).
//
// Design.  Words are independent, so each thread owns WPT = 2 neighbouring
// words (one 8-byte access per column) and reads and writes only its own
// words of every column: no __syncthreads() between gates.  The block's
// crossbar state lives in dynamic shared memory as
// state[col * threads + threadIdx.x], so a warp's access is contiguous.
// What held the first version back was latency: each gate waited for its
// row from a 259 KB table in L2, then for its operands.  So:
//  * the host packs each row into 8 bytes (four 12-bit columns, opcode,
//    inversion, group size; pim_bitserial.pack_rows), and the block stages
//    the table through shared memory in chunks of ROW_CHUNK rows with
//    16-byte cp.async, two stages, the next chunk in flight while the
//    current one executes, and each group's rows load while the group
//    before it runs;
//  * rows come in groups of up to GROUP gates, each reading only values
//    written by earlier groups (pim_bitserial.loop_groups list-schedules the
//    gates by dataflow: 3.9 a group for the f32 MAC, not the 2 of program
//    order's wave chunks).  A group issues every operand load of all its
//    gates, then computes, then stores: several shared loads in flight per
//    warp instead of one;
//  * every opcode is MAJ3(a, b, c) ^ invert, an operand that the opcode does
//    not read naming one of two constant columns (all zeros, all ones)
//    kept after the state's own: no branch on the opcode and no predicated
//    load stands between one gate's loads and the next's.
//
// Live state.  The state is over half an SM's shared memory, so an SM runs
// one block, and the state's width sets the block's words: 227 KB over
// (columns + 2) x 4 B a word.  The schedule's own columns hold every input
// from the start (19 float32 arguments are 608 of the nine-tap conv row's
// 672 columns), which left that program 64 words a block, one warp an SM,
// with one of the SM's four schedulers busy and every group waiting out its
// shared-memory round trip alone.  So the table is not on the schedule's
// columns but on the kernel's own (pim_bitserial.live_state): each write and
// each input is a value that holds a column only while it is live, which
// gives the nine-tap row 191 columns (288 words, 4.5 warps) and the f32 MAC
// 127 (416 words, 6.5 warps).  Inputs are staged, not preloaded: a table of
// (input, column) pairs a stage names the inputs that stage first reads, and
// while stage s runs each thread copies its own 8 bytes of stage s + 1's
// inputs from device memory with cp.async beside the table's next chunk,
// waited for at the stage barrier that is there anyway.  The host holds a
// staged column from the start of the stage before its first reader, so no
// row touches a column that a copy is filling.  Stage 0's inputs load
// before the loop; inputs returned unread are staged in a stage past the
// last.  Each plane is still read once.  Every column is written before it
// is read (a read of a column the schedule never wrote names the zero
// column), so only the constant columns are initialised; the rows that pad
// a stage write zero into the zero column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 4;        // pim_bitserial.GATE_GROUP
constexpr int ROW_CHUNK = 256;  // pim_bitserial.ROW_CHUNK
constexpr uint32_t COL_MASK = 0xFFFu;
// A packed row (pim_bitserial.pack_rows): x = a | op << 12 | invert << 15 |
// b << 16, y = c | (group size - 1) << 12 | o << 16.
constexpr int HALF_SHIFT = 16;
constexpr int INVERT_BIT = 15;
constexpr int GROUP_SHIFT = 12;

// Words a thread owns (pim_bitserial.LOOP_WORDS_PER_THREAD), one 8-byte
// access a column.
constexpr int WPT = 2;
using Word = uint2;

__device__ __forceinline__ Word splat(uint32_t m) { return make_uint2(m, m); }

__device__ __forceinline__ uint32_t maj3_xor(uint32_t a, uint32_t b, uint32_t c, uint32_t inv) {
  return ((a & b) | (c & (a | b))) ^ inv;
}
__device__ __forceinline__ Word maj3_xor(Word a, Word b, Word c, uint32_t inv) {
  return make_uint2(maj3_xor(a.x, b.x, c.x, inv), maj3_xor(a.y, b.y, c.y, inv));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One hazard-free group of N rows (held in registers): every load, then
// every store.  `col0` is this thread's word of column 0; columns lie
// `stride` bytes apart.
template <int N>
__device__ __forceinline__ void run_group(const uint2 (&rows)[GROUP], unsigned char* col0,
                                          uint32_t stride) {
  Word va[N], vb[N], vc[N];
  uint32_t out[N], inv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint2 r = rows[j];
    va[j] = *reinterpret_cast<const Word*>(col0 + (r.x & COL_MASK) * stride);
    vb[j] = *reinterpret_cast<const Word*>(col0 + (r.x >> HALF_SHIFT) * stride);
    vc[j] = *reinterpret_cast<const Word*>(col0 + (r.y & COL_MASK) * stride);
    inv[j] = static_cast<uint32_t>(static_cast<int32_t>(r.x << (31 - INVERT_BIT)) >> 31);
    out[j] = r.y >> HALF_SHIFT;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    *reinterpret_cast<Word*>(col0 + out[j] * stride) = maj3_xor(va[j], vb[j], vc[j], inv[j]);
}

__global__ void __launch_bounds__(1024) bitserial_loop_kernel(
    const uint32_t* __restrict__ planes_in,  // [n_in, W]
    uint32_t* __restrict__ planes_out,       // [n_out, W]
    const uint4* __restrict__ table,         // [n_rows / 2]: two packed rows each
    const int* __restrict__ stage_starts,    // [n_rows / ROW_CHUNK + 2]
    const int2* __restrict__ staged,         // (input, state column), by stage
    const int* __restrict__ out_slots,       // [n_out]
    int n_out, int n_rows, int state_cols, long long W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* stage_rows = reinterpret_cast<uint2*>(smem);                        // [2][ROW_CHUNK]
  Word* state = reinterpret_cast<Word*>(smem + 2 * ROW_CHUNK * sizeof(uint2));  // [cols][threads]
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const long long w = ((long long)blockIdx.x * threads + t) * WPT;
  const bool live = w < W;  // W is a multiple of WPT

  unsigned char* col0 = reinterpret_cast<unsigned char*>(state + t);  // my word of column 0
  const uint32_t stride = threads * sizeof(Word);                      // bytes between columns
  const int n_chunks = n_rows / ROW_CHUNK;
  constexpr int COPIES = ROW_CHUNK * sizeof(uint2) / 16;  // 16-byte copies a stage
  auto fetch = [&](int chunk) {
    uint4* dst = reinterpret_cast<uint4*>(stage_rows + (chunk & 1) * ROW_CHUNK);
    for (int i = t; i < COPIES; i += threads) cp_async16(dst + i, table + (long long)chunk * COPIES + i);
  };
  // This thread's words of stage s's inputs, into their state columns.
  auto stage_inputs = [&](int s) {
    if (!live) return;
    for (int k = __ldg(stage_starts + s), end = __ldg(stage_starts + s + 1); k < end; ++k) {
      const int2 e = __ldg(staged + k);
      cp_async8(state + e.y * threads + t, planes_in + e.x * W + w);
    }
  };

  state[state_cols * threads + t] = splat(0u);
  state[(state_cols + 1) * threads + t] = splat(~0u);
  stage_inputs(0);
  if (n_chunks > 0) fetch(0);  // a schedule with no gates has no table
  cp_async_commit();

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // The next stage's rows and inputs land while this stage runs.
    if (chunk + 1 < n_chunks) fetch(chunk + 1);
    stage_inputs(chunk + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // The rows of the next group load while the current group runs (past
    // the stage's end they read rows that are never used).
    const uint2* rows = stage_rows + (chunk & 1) * ROW_CHUNK;
    uint2 cur[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) cur[j] = rows[j];
    for (int r = 0; r < ROW_CHUNK;) {
      const int n = static_cast<int>((cur[0].y >> GROUP_SHIFT) & 3) + 1;
      uint2 next[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) next[j] = rows[r + n + j];
      switch (n) {
        case 1: run_group<1>(cur, col0, stride); break;
        case 2: run_group<2>(cur, col0, stride); break;
        case 3: run_group<3>(cur, col0, stride); break;
        default: run_group<GROUP>(cur, col0, stride); break;
      }
#pragma unroll
      for (int j = 0; j < GROUP; ++j) cur[j] = next[j];
      r += n;
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // the inputs returned unread

  if (live) {
    for (int j = 0; j < n_out; ++j) {
      *reinterpret_cast<Word*>(planes_out + j * W + w) = state[__ldg(out_slots + j) * threads + t];
    }
  }
}

}  // namespace

// n_rows is a multiple of ROW_CHUNK; words_per_block a multiple of 32; W a
// multiple of WPT.  Returns the launch's cudaError_t (0 on success).
extern "C" int bitserial_loop_launch(
    const void* planes_in, void* planes_out, const void* table, const void* stage_starts,
    const void* staged, const void* out_slots, int n_out, int n_rows, int state_cols,
    long long W, int words_per_block, void* stream) {
  if (n_rows % ROW_CHUNK || words_per_block % 32 || W % WPT) return (int)cudaErrorInvalidValue;
  const int threads = words_per_block / WPT;
  const size_t smem = 2 * ROW_CHUNK * sizeof(uint2) +
                      (size_t)(state_cols + 2) * words_per_block * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      bitserial_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (W + words_per_block - 1) / words_per_block;
  bitserial_loop_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)planes_in, (uint32_t*)planes_out, (const uint4*)table,
      (const int*)stage_starts, (const int2*)staged, (const int*)out_slots, n_out, n_rows,
      state_cols, W);
  return (int)cudaGetLastError();
}

extern "C" const char* bitserial_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
