// Loop-mode bit-serial gate-schedule executor for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (driven by `_run`) in
// src/repro/kernels/pim_bitserial.py: execute any column-allocated PIM gate
// schedule over packed bit-planes.  Each 32-bit word holds one bit of 32
// elements; a schedule row (op, a, b, c, o) overwrites column o with
// NOR / MAJ3 / NOT / INIT0 / INIT1 / COPY of whole columns.
//
// Design.  Words are independent, so one thread owns one packed word and
// reads and writes only its own word of every column: no __syncthreads()
// between gates.  The block's crossbar state lives in dynamic shared memory
// as state[col * words_per_block + threadIdx.x], so the 32 lanes of a warp
// hit 32 neighbouring banks.  Gate rows come from global memory through the
// read-only path at a warp-uniform address (a broadcast); __constant__ does
// not fit the main path (12 968 rows x 20 B = 259 KB > 64 KB).  Non-input
// columns start at zero, as the reference scratch does.
//
// Bound on this card.  Each gate is one 32-bit logic op per word, so the
// work is gates x W ops on the INT32 lanes, against (n_in + n_out) x W x 4 B
// of boundary planes: the fused f32 MAC (12 968 gates, 128 boundary planes)
// is bound by logic throughput.  This simple kernel instead pays up to three
// shared-memory loads and one store per gate-word plus the row fetch and the
// opcode dispatch, so shared-memory bandwidth and instruction issue set its
// pace well above that bound; at 160 columns x 256 words (160 KiB) one block
// fits on an SM.  Making it faster (columns in registers, several words per
// thread) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Opcodes: the numbering of repro_torch.core.machine.
constexpr int OP_NOR = 0;
constexpr int OP_INIT0 = 1;
constexpr int OP_INIT1 = 2;
constexpr int OP_COPY = 3;
constexpr int OP_NOT = 4;
constexpr int OP_MAJ3 = 5;

__global__ void bitserial_loop_kernel(
    const uint32_t* __restrict__ planes_in,  // [n_in, W]
    uint32_t* __restrict__ planes_out,       // [n_out, W]
    const int* __restrict__ gates,           // [n_gates, 5] (op, a, b, c, o)
    const int* __restrict__ in_slots,        // [n_in]
    const int* __restrict__ out_slots,       // [n_out]
    int n_in, int n_out, int n_gates, int num_cols, long long W) {
  extern __shared__ uint32_t state[];
  const int wpb = blockDim.x;
  const int t = threadIdx.x;
  const long long w = (long long)blockIdx.x * wpb + t;
  const bool live = w < W;

  for (int col = 0; col < num_cols; ++col) state[col * wpb + t] = 0u;
  for (int i = 0; i < n_in; ++i) {
    state[__ldg(in_slots + i) * wpb + t] = live ? planes_in[i * W + w] : 0u;
  }

  for (int g = 0; g < n_gates; ++g) {
    const int* row = gates + 5 * g;
    const int op = __ldg(row);
    const int a = __ldg(row + 1);
    uint32_t r;
    switch (op) {
      case OP_NOR:
        r = ~(state[a * wpb + t] | state[__ldg(row + 2) * wpb + t]);
        break;
      case OP_MAJ3: {
        const uint32_t va = state[a * wpb + t];
        const uint32_t vb = state[__ldg(row + 2) * wpb + t];
        const uint32_t vc = state[__ldg(row + 3) * wpb + t];
        r = (va & vb) | (va & vc) | (vb & vc);
        break;
      }
      case OP_NOT:
        r = ~state[a * wpb + t];
        break;
      case OP_INIT0:
        r = 0u;
        break;
      case OP_INIT1:
        r = 0xFFFFFFFFu;
        break;
      default:  // OP_COPY
        r = state[a * wpb + t];
        break;
    }
    state[__ldg(row + 4) * wpb + t] = r;
  }

  if (live) {
    for (int j = 0; j < n_out; ++j) {
      planes_out[j * W + w] = state[__ldg(out_slots + j) * wpb + t];
    }
  }
}

}  // namespace

extern "C" int bitserial_loop_launch(
    const void* planes_in, void* planes_out, const void* gates,
    const void* in_slots, const void* out_slots, int n_in, int n_out,
    int n_gates, int num_cols, long long W, int words_per_block,
    void* stream) {
  const size_t smem = (size_t)num_cols * words_per_block * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      bitserial_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (W + words_per_block - 1) / words_per_block;
  bitserial_loop_kernel<<<(unsigned)blocks, words_per_block, smem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)planes_in, (uint32_t*)planes_out, (const int*)gates,
      (const int*)in_slots, (const int*)out_slots, n_in, n_out, n_gates,
      num_cols, W);
  return (int)cudaGetLastError();
}

extern "C" const char* bitserial_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
