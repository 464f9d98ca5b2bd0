// Bit-sliced, ADC-saturating CIM crossbar MVM for Hopper (sm_90a).
//
// Replaces the TPU kernels cim_mvm_tiles_pallas (and, at T = 1,
// cim_mvm_pallas) of src/repro/kernels/cim_mvm/kernel.py.  It computes
// what the plain version cim_mvm_ref_tiles (kernels/cim_mvm/ref.py)
// computes, bit for bit:
//
//   y[t,m,c] = sum_g sum_p sum_s 2^(p*db + s*cb) *
//              min( sum_{r in g} x_p[t,m,r] * w_s[t,r,c], adc_max )
//
// x_p = (x >> p*db) & (2^db - 1) and w_s = (w >> s*cb) & (2^cb - 1) are
// the DAC phases and cell slices; the row groups g are runs of
// parallel_row rows, the rows of one analog read.  All sums are taken
// mod 2^32, as the plain version's int32 arithmetic wraps.
//
// Bound on the card: operands move (T*M*R + T*R*C) * elem + T*M*C*4
// bytes at 3.35 TB/s, and the work is 2*T*M*C*R*P*S plane operations,
// against 1979 TOPS of int8 tensor-core rate.  For the executor's
// shapes (R in the hundreds to thousands, P = S = 8 on jia-issc21) the
// operations bound by far: the data is tiny next to the P*S-fold plane
// work.  Small crossbars (puma: P = 1, S = 4, C = 32) are bound by bytes.
//
// Two bodies, chosen by the operand type (elem_bytes):
//
// uint8 operands (every plane in the low byte; all five arch presets):
// wgmma_kernel, a warp-specialised kernel built on wgmma, TMA and mbarriers.
//   * Split.  Each (group g, phase p, slice s) term is clamped on its
//     own and then only added, so the work splits across blocks by
//     output tile (64 x 64 of one crossbar tile t), by a range of row
//     groups and by a range of phases; a block keeps all S slices of its
//     phases.  The host's launch planner (kernel.py::plan_launch) picks
//     the ranges that minimise the busiest SM's load in whole waves of one
//     block per SM, preferring group splits (a phase split repeats the
//     slice-plane pass below) and equal phase ranges.  Blocks add their
//     totals into `out` (zeroed by the wrapper) with 32-bit atomics:
//     integer addition mod 2^32 in any order gives the same bits, so
//     results are identical run to run.
//   * Operand roles.  The plane products run as
//     wgmma.mma_async.m64n64k32.s32.u8.u8 with A (64 output rows x 32 k)
//     in registers and B (32 k x 64 output columns) in shared memory.
//     8-bit wgmma takes K-major operands only.  x (T,M,R) is K-major as
//     stored, so its phase planes go from the staged raw bytes straight
//     into A registers: a 32-bit word holds 4 consecutive k of one row,
//     and (word >> p*db) & ((2^db - 1) * 0x01010101) is the packed plane
//     in one shift and one AND.  w (T,R,C) is N-major, so its slice
//     planes are the operand that takes a shared-memory pass: per staged
//     chunk and sweep the consumers read 4 x 4 byte blocks of raw w,
//     transpose them with byte permutes, extract the sweep's slices and
//     store them K-major in the no-swizzle core-matrix layout (8 columns x
//     16 k bytes a core; 8-column groups 1040 bytes apart, one 16-byte
//     row of padding, so the stores meet each bank at most twice).  x
//     takes the register side because its planes cost two ALU operations
//     a register and no shared memory, and because the 64-row wgmma
//     granule then falls on M while N takes C (32 on puma).  After the
//     pass, fence.proxy.async makes the generic stores visible to wgmma
//     and a named barrier over the 256 consumer threads orders them; three
//     plane buffers let a pass run while earlier chunks' wgmmas drain.
//   * Sweeps and registers.  The clamp is per (group, phase, slice), so a
//     pair's s32 accumulator (32 registers a thread for m64n64) lives over
//     its whole group.  A sweep runs the block's np phases against sb
//     slices (sb = 2 when np <= 4, else 1): at most 8 pairs, LIVE =
//     ceil(np * sb / 2) of them a warpgroup (a template argument; 128
//     accumulator registers at LIVE = 4, and 32 for the uint32 totals).
//     The two consumer warpgroups share the 64 rows and the slice planes
//     and take alternate pairs, so each extracts only its own phases.
//     setmaxnreg gives the consumers 232 registers and the producers 40.
//     At a group's end each pair is clamped at adc_max, shifted by
//     p*db + s*cb and added into the totals; warpgroup 1 hands its totals
//     to warpgroup 0 through shared memory, so each output gets one atomic
//     add a block.
//   * The wgmma groups.  The wgmmas read their A registers asynchronously,
//     and ptxas serialises every wgmma of a kernel where an instruction
//     other than a wgmma defines one of their inputs while a group is in
//     flight.  So a warpgroup computes two k-steps' A planes and
//     descriptors, fences (the fence takes the descriptors as operands,
//     so they are computed before it), starts their LIVE x 2 wgmmas as
//     one group with scale-d an immediate, and retires the group before
//     it defines the next one's inputs; the other warpgroup's group and
//     the next chunk's plane pass fill the gap.
//   * Ring and warp roles.  Warps 8-11 are the producer warpgroup: it
//     keeps raw 128-row chunks of x (64 x 128 bytes) and w (128 x 64 bytes)
//     in flight in a STAGES-deep ring (9-11 stages, whatever fits 227 KB
//     beside the plane buffers), each slot with a full and an empty
//     mbarrier.  Warps 0-7 are the two consumer warpgroups.  When a whole
//     row group fits in the ring (parallel_row <= 128 * stages: every
//     preset), a group's chunks are staged once and stay resident for all
//     of its sweeps, and the empty barrier is signalled after the last
//     sweep; otherwise each sweep streams the group again.
//   * Load paths.  Where the global strides allow it (base and row pitch
//     multiples of 16 bytes, and parallel_row too for x), a chunk is one
//     TMA box (cp.async.bulk.tensor; tensor maps encoded on the host for
//     each launch through cuTensorMapEncodeTiled, looked up with
//     cudaGetDriverEntryPoint, and passed as __grid_constant__
//     parameters); x lands 128-byte swizzled, so the A-fragment loads meet
//     no bank twice; rows and columns out of range fill with zeros.
//     Otherwise (R = 147, R = 854, C = 488, a base off the 16-byte grid)
//     the producer warpgroup copies the aligned 4-byte words that cover
//     each row with cp.async, and the full barrier tracks them
//     (cp.async.mbarrier.arrive.noinc); a row keeps its offset within a
//     word, which the consumers undo with a funnel shift.  Rows past a
//     group's end are zero in the slice planes, so what x holds there
//     adds nothing; nothing is padded on the host.
//   * What bounds it now (tools/cim_mvm_ablation.py, an H100 80GB HBM3
//     at 700 W): the CUDA-core work around the wgmmas, not the tensor
//     cores.  ResNet-18@224's 32 launches take 2.40-2.43 ms (5.1-5.2x
//     their bound by operations), 1.92-1.94 ms without the plane pass,
//     2.16-2.25 ms without the A-plane extraction and still 1.52-1.58 ms
//     with no wgmma at all.  Fewer
//     ALU operations a plane (x as the B operand, so that its planes are
//     a vectorised pass; a wider N per wgmma), a transposed w kept across
//     sweeps, and a persistent grid that overlaps a tile's first loads
//     with the previous tile's work are the next levers.
//
// int32 operands (a plane past the low byte; no preset, only sweep
// cases): cuda_core_kernel, the first port's CUDA-core body.  A block
// owns a 64 x 64 output tile, walks all groups and (p, s) pairs, stages
// a group as stored int32 and extracts planes in registers; int32 MACs,
// clamp, shift-add, plain stores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

namespace {

// ------------------------------------------------- tensor-core instantiation
// Tile constants; kernel.py's planner holds the same numbers and the
// launch refuses a plan made for others.
constexpr int BM = 64;                  // output rows per block
constexpr int BN = 64;                  // output columns per block (wgmma N)
constexpr int KC = 128;                 // k rows per staged chunk
constexpr int KSTEP = 32;               // k of one wgmma
constexpr int CONSUMERS = 256;          // two consumer warpgroups
constexpr int PRODUCERS = 128;          // and one producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int CONSUMER_REGS = 232;      // setmaxnreg: 2 x 128 x 232 +
constexpr int PRODUCER_REGS = 40;       // 128 x 40 <= 65536
constexpr int PAIRS = 4;                // (phase, slice) pairs a warpgroup
constexpr int MAX_S = 8;                // slices of a uint8 weight
constexpr int MAX_STAGES = 16;
constexpr int SMEM_LIMIT = 232448;      // a block's shared-memory ceiling
constexpr int ALIGN = 1024;             // the 128-byte swizzle's period
// staged raw chunks: TMA boxes, or rows of cp.async words (one word of
// slack for a row's offset, padded so fragment loads miss no bank twice)
constexpr int X_TMA_BYTES = BM * KC;
constexpr int X_CP_PITCH = KC + 16;
constexpr int X_CP_BYTES = BM * X_CP_PITCH;
constexpr int W_TMA_BYTES = KC * BN;
constexpr int W_CP_PITCH = BN + 16;
constexpr int W_CP_BYTES = KC * W_CP_PITCH;
// K-major slice planes in the no-swizzle core-matrix layout
constexpr int CORE = 128;               // 8 columns x 16 k bytes
constexpr int LBO = CORE;               // next core along k
constexpr int SBO = (KC / 16) * CORE + 16;   // next 8 columns, padded
constexpr int PLANE = (BN / 8) * SBO;
constexpr int PLANE_SET = 2 * PLANE;    // the slices of one sweep
constexpr int PLANE_SETS = 3;
constexpr int RING_OFFSET = (PLANE_SETS * PLANE_SET + ALIGN - 1) / ALIGN * ALIGN;
constexpr int BARRIER_BYTES = 2 * MAX_STAGES * 8;

static_assert(BM * BN * 4 <= PLANE_SETS * PLANE_SET,
              "the totals hand-over reuses the plane buffers");

// A ring slot: one chunk of x and one of w, by their load paths.
__host__ __device__ constexpr int stage_bytes(bool x_tma, bool w_tma) {
  return (x_tma ? X_TMA_BYTES : X_CP_BYTES) +
         (w_tma ? W_TMA_BYTES : W_CP_BYTES);
}

// As many slots as fit beside the plane buffers, at most MAX_STAGES.
__host__ __device__ constexpr int ring_stages(bool x_tma, bool w_tma) {
  constexpr int room = SMEM_LIMIT - ALIGN - RING_OFFSET - BARRIER_BYTES;
  return room / stage_bytes(x_tma, w_tma) < MAX_STAGES
             ? room / stage_bytes(x_tma, w_tma)
             : MAX_STAGES;
}

__host__ __device__ constexpr int wgmma_smem(bool x_tma, bool w_tma) {
  return ALIGN + RING_OFFSET +
         ring_stages(x_tma, w_tma) * stage_bytes(x_tma, w_tma) +
         BARRIER_BYTES;
}

// A sweep runs a block's np phases against two slices while that keeps
// to 2 * PAIRS pairs, else against one; the two consumer warpgroups take
// alternate pairs, ceil(np * sb / 2) each.
__host__ __device__ constexpr int sweep_slices(int np) {
  return np <= PAIRS ? 2 : 1;
}

__host__ __device__ constexpr int live_pairs(int np) {
  return (np * sweep_slices(np) + 1) / 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// the barrier completes a phase only after this thread's earlier
// cp.async copies have landed (counts as one of its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// The fence takes the group's descriptors as operands so that they are
// computed before it.
template <int N>
__device__ __forceinline__ void wgmma_fence(const uint64_t (&d0)[N],
                                            const uint64_t (&d1)[N]) {
  asm volatile("wgmma.fence.sync.aligned;\n"
               :: "l"(d0[0]), "l"(d0[N > 1 ? 1 : 0]), "l"(d0[N > 2 ? 2 : 0]),
                  "l"(d0[N > 3 ? 3 : 0]), "l"(d1[0]), "l"(d1[N > 1 ? 1 : 0]),
                  "l"(d1[N > 2 ? 2 : 0]), "l"(d1[N > 3 ? 3 : 0])
               : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// retires every wgmma group this warpgroup committed
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_acc(uint32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// B: K-major, no swizzle; start, leading (k) and stride (n) byte offsets
// in 16-byte units
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

// d += a (64 x 32 u8, registers) * b (32 x 64 u8, shared memory)
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  // scale-d is the immediate 1 (D += A * B): no instruction may define a
  // wgmma input between the fence and the commit
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, %37;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// byte offset of 4-byte word (n, 4*kq .. 4*kq+3) in a slice plane
__device__ __forceinline__ int plane_offset(int n, int kq) {
  return (n >> 3) * SBO + (kq >> 2) * CORE + (n & 7) * 16 + (kq & 3) * 4;
}

// low byte offset of a row within its 4-byte word
__device__ __forceinline__ int word_offset(const uint8_t* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
}

// 4 bytes at byte q of a staged cp.async row (q need not be aligned)
__device__ __forceinline__ uint32_t lds32_at(const uint8_t* row, int q) {
  const uint8_t* p = row + (q & ~3);
  return __funnelshift_r(lds32(p), lds32(p + 4), (q & 3) * 8);
}

// Rows [g*pr, min(R, (g+1)*pr)) of group g, in chunks of KC.
__device__ __forceinline__ int group_chunks(int g, int R, int pr) {
  return (min(R, (g + 1) * pr) - g * pr + KC - 1) / KC;
}

// LIVE: pairs a consumer warpgroup runs in each sweep, live_pairs(np)
template <bool X_TMA, bool W_TMA, int LIVE>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
             const __grid_constant__ CUtensorMap w_map,
             const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
             uint32_t* __restrict__ out, int M, int R, int C, int n_p,
             int n_s, int db, int cb, int pr, int adc_max, int gpb, int ppb,
             int resident) {
  constexpr int X_SLOT = X_TMA ? X_TMA_BYTES : X_CP_BYTES;
  constexpr int STAGE = stage_bytes(X_TMA, W_TMA);
  constexpr int STAGES = ring_stages(X_TMA, W_TMA);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                              (ALIGN - 1));
  uint8_t* planes = smem;
  uint8_t* ring = smem + RING_OFFSET;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + MAX_STAGES;

  // which output tile, groups and phases this block owns
  const int n_ct = (C + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_ct) * BM;
  const int c0 = (blockIdx.x % n_ct) * BN;
  const int p_splits = (n_p + ppb - 1) / ppb;
  const int n_groups = (R + pr - 1) / pr;
  const int g_begin = (blockIdx.y / p_splits) * gpb;
  const int g_end = min(n_groups, g_begin + gpb);
  const int p_begin = (blockIdx.y % p_splits) * ppb;
  const int np = min(n_p, p_begin + ppb) - p_begin;
  const int t = blockIdx.z;
  const int sb = sweep_slices(np);
  const int sweeps = (n_s + sb - 1) / sb;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_u32(full + i), X_TMA && W_TMA ? 1 : 1 + PRODUCERS);
      mbar_init(smem_u32(empty + i), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int ptid = tid - CONSUMERS;
    int it = 0;
    for (int g = g_begin; g < g_end; ++g) {
      const int gbeg = g * pr, gend = min(R, gbeg + pr);
      const int nch = group_chunks(g, R, pr);
      const int passes = resident ? 1 : sweeps;
      for (int pass = 0; pass < passes; ++pass) {
        for (int ch = 0; ch < nch; ++ch, ++it) {
          const int slot = it % STAGES;
          mbar_wait(smem_u32(empty + slot), ((it / STAGES) & 1) ^ 1);
          uint8_t* xs = ring + slot * STAGE;
          uint8_t* ws = xs + X_SLOT;
          const uint32_t fb = smem_u32(full + slot);
          const int k0 = gbeg + ch * KC;
          const int kv = min(KC, gend - k0);
          if (ptid == 0) {
            if (X_TMA || W_TMA) {
              mbar_expect_tx(fb, (X_TMA ? X_TMA_BYTES : 0) +
                                     (W_TMA ? W_TMA_BYTES : 0));
            } else {
              mbar_arrive(fb);
            }
            if (X_TMA) tma_load_3d(smem_u32(xs), &x_map, fb, k0, m0, t);
            if (W_TMA) tma_load_3d(smem_u32(ws), &w_map, fb, c0, k0, t);
          }
          if (!X_TMA) {
            // the aligned words covering each row's kv bytes; rows past M
            // stay stale (their outputs are never stored)
            constexpr int WORDS = X_CP_PITCH / 4 - 3;
            for (int i = ptid; i < BM * WORDS; i += PRODUCERS) {
              const int mm = i / WORDS, j = i - mm * WORDS;
              if (m0 + mm >= M) break;
              const uint8_t* row = x + ((size_t)t * M + m0 + mm) * R + k0;
              if (j < (word_offset(row) + kv + 3) / 4)
                cp_async4(smem_u32(xs + mm * X_CP_PITCH + 4 * j),
                          row - word_offset(row) + 4 * j);
            }
          }
          if (!W_TMA) {
            constexpr int WORDS = W_CP_PITCH / 4 - 3;
            const int nc = min(BN, C - c0);
            for (int i = ptid; i < kv * WORDS; i += PRODUCERS) {
              const int kk = i / WORDS, j = i - kk * WORDS;
              const uint8_t* row = w + ((size_t)t * R + k0 + kk) * C + c0;
              if (j < (word_offset(row) + nc + 3) / 4)
                cp_async4(smem_u32(ws + kk * W_CP_PITCH + 4 * j),
                          row - word_offset(row) + 4 * j);
            }
          }
          if (!X_TMA || !W_TMA) cp_async_arrive(fb);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = tid / 128;                 // consumer warpgroup
  const int wtid = tid % 128;
  const int lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // fragment coordinates
  const int ma = (wtid / 32) * 16 + gid;     // A rows ma and ma + 8
  // plane pass: 4 x 4 byte blocks (k rows 4*kq.., columns 4*pc4..)
  const int pc4 = tid % 16, pkq = tid / 16;
  const uint32_t pmask = ((1u << db) - 1) * 0x01010101u;
  const uint32_t smask = ((1u << cb) - 1) * 0x01010101u;

  uint32_t acc[LIVE][32];
  uint32_t tot[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) tot[r] = 0;

  int it = 0, pset_i = 0;
  for (int g = g_begin; g < g_end; ++g) {
    const int gbeg = g * pr, gend = min(R, gbeg + pr);
    const int nch = group_chunks(g, R, pr);
    for (int sw = 0; sw < sweeps; ++sw) {
      const int s0 = sw * sb;
      const int nsl = min(sb, n_s - s0);
      // this warpgroup's pairs: j = 2*i + wg of the sweep's np * sb; a
      // pair past the last slice (S = 1) runs on a zero plane mask
      bool act[LIVE];
      uint32_t xsh[LIVE], xmask[LIVE], osh[LIVE];
      int psl[LIVE];
#pragma unroll
      for (int i = 0; i < LIVE; ++i) {
        const int j = 2 * i + wg;
        const int p = p_begin + j % np, sl = j / np;
        act[i] = sl < nsl;
        xsh[i] = p * db;
        xmask[i] = act[i] ? pmask : 0u;
        osh[i] = p * db + (s0 + sl) * cb;
        psl[i] = act[i] ? sl : 0;
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[i][r] = 0;
      }
      for (int ch = 0; ch < nch; ++ch) {
        const int i_stream = it + (resident ? ch : sw * nch + ch);
        const int slot = i_stream % STAGES;
        mbar_wait(smem_u32(full + slot), (i_stream / STAGES) & 1);
        const uint8_t* xs = ring + slot * STAGE;
        const uint8_t* ws = xs + X_SLOT;
        const int k0 = gbeg + ch * KC;
        const int kv = min(KC, gend - k0);
        const int nks = (kv + KSTEP - 1) / KSTEP;
        uint8_t* pset = planes + (pset_i % PLANE_SETS) * PLANE_SET;

        // slice planes of this chunk, K-major; rows past kv are zero
#pragma unroll
        for (int item = 0; item < 2; ++item) {
          const int kq = pkq + 16 * item;
          if (4 * kq >= nks * KSTEP) continue;
          uint32_t rw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = 4 * kq + j;
            if (kk >= kv) {
              rw[j] = 0;
            } else if (W_TMA) {
              rw[j] = lds32(ws + kk * BN + 4 * pc4);
            } else {
              const uint8_t* row = w + ((size_t)t * R + k0 + kk) * C + c0;
              rw[j] = lds32_at(ws + kk * W_CP_PITCH,
                               word_offset(row) + 4 * pc4);
            }
          }
          const uint32_t u0 = __byte_perm(rw[0], rw[1], 0x5140);
          const uint32_t u1 = __byte_perm(rw[0], rw[1], 0x7362);
          const uint32_t v0 = __byte_perm(rw[2], rw[3], 0x5140);
          const uint32_t v1 = __byte_perm(rw[2], rw[3], 0x7362);
          const uint32_t col[4] = {__byte_perm(u0, v0, 0x5410),
                                   __byte_perm(u0, v0, 0x7632),
                                   __byte_perm(u1, v1, 0x5410),
                                   __byte_perm(u1, v1, 0x7632)};
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            if (sl < nsl) {
              const int sh = (s0 + sl) * cb;
              uint8_t* plane = pset + sl * PLANE;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                *reinterpret_cast<uint32_t*>(
                    plane + plane_offset(4 * pc4 + c, kq)) =
                    (col[c] >> sh) & smask;
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync();

        // A rows' offsets within their words (cp.async path)
        int da = 0, db8 = 0;
        if (!X_TMA) {
          da = word_offset(x + ((size_t)t * M + m0 + ma) * R + k0);
          db8 = word_offset(x + ((size_t)t * M + m0 + ma + 8) * R + k0);
        }
        const uint32_t pbase = smem_u32(pset);
        // the pairs' phase planes of k-step ks into the register set A, and
        // the slice-plane descriptors
        auto planes_of = [&](uint32_t(&A)[LIVE][4], uint64_t(&desc)[LIVE],
                             int ks) {
          const int kb = ks * KSTEP + tig * 4;
          uint32_t raw[4];
          if (X_TMA) {
            // 128-byte swizzle: 16-byte chunk c of row m sits at c ^ (m & 7)
            const uint8_t* ra = xs + ma * KC;
            const int lo = (((kb >> 4) ^ gid) << 4) | (kb & 15);
            const int hi = ((((kb >> 4) + 1) ^ gid) << 4) | (kb & 15);
            raw[0] = lds32(ra + lo);
            raw[1] = lds32(ra + 8 * KC + lo);
            raw[2] = lds32(ra + hi);
            raw[3] = lds32(ra + 8 * KC + hi);
          } else {
            const uint8_t* ra = xs + ma * X_CP_PITCH;
            const uint8_t* rb = ra + 8 * X_CP_PITCH;
            raw[0] = lds32_at(ra, da + kb);
            raw[1] = lds32_at(rb, db8 + kb);
            raw[2] = lds32_at(ra, da + kb + 16);
            raw[3] = lds32_at(rb, db8 + kb + 16);
          }
#pragma unroll
          for (int i = 0; i < LIVE; ++i) {
            desc[i] = b_desc(pbase + psl[i] * PLANE + ks * 2 * CORE);
#pragma unroll
            for (int r = 0; r < 4; ++r) A[i][r] = (raw[r] >> xsh[i]) & xmask[i];
          }
        };
        // Two k-steps a wgmma group.  The wgmmas read their A registers
        // asynchronously, so the previous group is retired before any of
        // the next group's inputs is defined; the group left in flight at
        // a chunk's end overlaps the next chunk's plane pass.
#pragma unroll 1
        for (int ks = 0; ks < nks; ks += 2) {
          uint32_t a0[LIVE][4], a1[LIVE][4];
          uint64_t d0[LIVE], d1[LIVE];
          wgmma_wait_all();
          planes_of(a0, d0, ks);
          if (ks + 1 < nks) {
            planes_of(a1, d1, ks + 1);
            wgmma_fence(d0, d1);
#pragma unroll
            for (int i = 0; i < LIVE; ++i) wgmma_u8(acc[i], a0[i], d0[i]);
#pragma unroll
            for (int i = 0; i < LIVE; ++i) wgmma_u8(acc[i], a1[i], d1[i]);
          } else {
            wgmma_fence(d0, d0);
#pragma unroll
            for (int i = 0; i < LIVE; ++i) wgmma_u8(acc[i], a0[i], d0[i]);
          }
          wgmma_commit();
        }
        // every read of this slot is done: release it after its last use
        if (!resident || sw == sweeps - 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(empty + slot));
        }
        ++pset_i;
      }
      wgmma_wait_all();
      // the group's analog reads: ADC clamp, digital shift-add (uint32
      // wraps like the plain version's int32)
#pragma unroll
      for (int i = 0; i < LIVE; ++i) {
        fence_acc(acc[i]);
        const uint32_t keep = act[i] ? ~0u : 0u;
#pragma unroll
        for (int r = 0; r < 32; ++r)
          tot[r] += (static_cast<uint32_t>(
                         min(static_cast<int>(acc[i][r]), adc_max))
                     << osh[i]) & keep;
      }
    }
    it += resident ? nch : sweeps * nch;
  }

  // warpgroup 1 hands its totals to warpgroup 0 through the (drained)
  // plane buffers; one atomic add an output
  uint32_t* handover = reinterpret_cast<uint32_t*>(planes);
  consumer_sync();
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < 32; ++r) handover[r * 128 + wtid] = tot[r];
  }
  consumer_sync();
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int m = m0 + ma + 8 * ((r >> 1) & 1);
    const int c = c0 + 8 * (r >> 2) + 2 * tig + (r & 1);
    if (m < M && c < C)
      atomicAdd(out + ((size_t)t * M + m) * C + c,
                tot[r] + handover[r * 128 + wtid]);
  }
}

// -------------------------------------------------- CUDA-core instantiation
constexpr int CC_TILE = 64;        // output rows and columns per block
constexpr int CC_THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int CC_SMEM_BUDGET = 160 * 1024;

__global__ void __launch_bounds__(CC_THREADS)
cuda_core_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                 int32_t* __restrict__ out, int M, int R, int C, int n_p,
                 int n_s, int db, int cb, int pr, int adc_max, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* xs = reinterpret_cast<int32_t*>(smem_raw);   // [CC_TILE][kc]
  int32_t* ws = xs + CC_TILE * kc;                      // [kc][CC_TILE]

  const int n_ct = (C + CC_TILE - 1) / CC_TILE;
  const int m0 = (blockIdx.x / n_ct) * CC_TILE;
  const int c0 = (blockIdx.x % n_ct) * CC_TILE;
  const int t = blockIdx.z;
  const int32_t* xt = x + (size_t)t * M * R;
  const int32_t* wt = w + (size_t)t * R * C;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int xmask = (1 << db) - 1, wmask = (1 << cb) - 1;

  int32_t y[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) y[i][j] = 0;

  for (int g0 = 0; g0 < R; g0 += pr) {
    const int glen = min(pr, R - g0);
    const int n_chunks = (glen + kc - 1) / kc;
    for (int ps = 0; ps < n_p * n_s; ++ps) {
      const int xsh = (ps / n_s) * db;
      const int wsh = (ps % n_s) * cb;
      int32_t acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

      for (int ch = 0; ch < n_chunks; ++ch) {
        const int k0 = g0 + ch * kc;
        const int klen = min(kc, g0 + glen - k0);
        // a single-chunk group stays staged for all (p, s) pairs
        if (n_chunks > 1 || ps == 0) {
          __syncthreads();
          for (int i = tid; i < CC_TILE * kc; i += CC_THREADS) {
            const int mm = i / kc, kk = i % kc;
            xs[i] = (m0 + mm < M && kk < klen)
                        ? xt[(size_t)(m0 + mm) * R + k0 + kk] : 0;
          }
          for (int i = tid; i < kc * CC_TILE; i += CC_THREADS) {
            const int kk = i / CC_TILE, cc = i % CC_TILE;
            ws[i] = (kk < klen && c0 + cc < C)
                        ? wt[(size_t)(k0 + kk) * C + c0 + cc] : 0;
          }
          __syncthreads();
        }
        for (int kk = 0; kk < klen; ++kk) {
          int32_t xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[i] = (xs[(ty + 16 * i) * kc + kk] >> xsh) & xmask;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = (ws[kk * CC_TILE + tx + 16 * j] >> wsh) & wmask;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * wv[j];
        }
      }
      const int sh = xsh + wsh;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          y[i][j] = (int32_t)((uint32_t)y[i][j] +
                              ((uint32_t)min(acc[i][j], adc_max) << sh));
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < C) out[((size_t)t * M + m) * C + c] = y[i][j];
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Raise a kernel's dynamic shared-memory ceiling once per device; every
// launch stays within it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

bool wgmma_smem_set[4 * PAIRS][MAX_DEVICES] = {};
bool cc_smem_set[MAX_DEVICES] = {};

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library links against libcudart alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (T, rows, inner) uint8 tensor as 3-D tiles of box_inner x box_rows x 1
// (zero fill out of range).
bool encode_3d(CUtensorMap* map, const void* base, int T, int rows,
               int inner, int box_inner, int box_rows, bool swizzle128) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)inner,
                                 (cuuint64_t)inner * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 16-byte rule: TMA needs a 16-byte-aligned base and row pitch; x's
// chunks also start at multiples of parallel_row.
bool x_takes_tma(const void* x, int R, int pr) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && R % 16 == 0 &&
         pr % 16 == 0;
}

bool w_takes_tma(const void* w, int C) {
  return reinterpret_cast<uintptr_t>(w) % 16 == 0 && C % 16 == 0;
}

template <bool X_TMA, bool W_TMA, int LIVE>
cudaError_t launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm,
                         const void* x, const void* w, void* out, int T,
                         int M, int R, int C, int n_p, int n_s, int db,
                         int cb, int pr, int adc_max, int gpb, int ppb,
                         int grid_x, int grid_y, int resident,
                         cudaStream_t s) {
  constexpr int smem = wgmma_smem(X_TMA, W_TMA);
  cudaError_t err =
      allow_smem(wgmma_kernel<X_TMA, W_TMA, LIVE>, smem,
                 wgmma_smem_set[(2 * X_TMA + W_TMA) * PAIRS + LIVE - 1]);
  if (err != cudaSuccess) return err;
  wgmma_kernel<X_TMA, W_TMA, LIVE>
      <<<dim3(grid_x, grid_y, T), THREADS, smem, s>>>(
          xm, wm, static_cast<const uint8_t*>(x),
          static_cast<const uint8_t*>(w), static_cast<uint32_t*>(out), M, R,
          C, n_p, n_s, db, cb, pr, adc_max, gpb, ppb, resident);
  return cudaGetLastError();
}

template <bool X_TMA, bool W_TMA>
cudaError_t launch_live(const CUtensorMap& xm, const CUtensorMap& wm,
                        const void* x, const void* w, void* out, int T,
                        int M, int R, int C, int n_p, int n_s, int db, int cb,
                        int pr, int adc_max, int gpb, int ppb, int grid_x,
                        int grid_y, int resident, cudaStream_t s) {
  switch (live_pairs(ppb)) {
    case 1:
      return launch_wgmma<X_TMA, W_TMA, 1>(xm, wm, x, w, out, T, M, R, C, n_p,
                                           n_s, db, cb, pr, adc_max, gpb, ppb,
                                           grid_x, grid_y, resident, s);
    case 2:
      return launch_wgmma<X_TMA, W_TMA, 2>(xm, wm, x, w, out, T, M, R, C, n_p,
                                           n_s, db, cb, pr, adc_max, gpb, ppb,
                                           grid_x, grid_y, resident, s);
    case 3:
      return launch_wgmma<X_TMA, W_TMA, 3>(xm, wm, x, w, out, T, M, R, C, n_p,
                                           n_s, db, cb, pr, adc_max, gpb, ppb,
                                           grid_x, grid_y, resident, s);
    default:
      return launch_wgmma<X_TMA, W_TMA, 4>(xm, wm, x, w, out, T, M, R, C, n_p,
                                           n_s, db, cb, pr, adc_max, gpb, ppb,
                                           grid_x, grid_y, resident, s);
  }
}

}  // namespace

// x: (T,M,R), w: (T,R,C), out: (T,M,C) int32, all contiguous on the
// current device, out zeroed; elem_bytes is 1 (uint8 operands: the
// tensor-core kernel) or 4 (int32: the CUDA-core kernel).  The launch
// plan (tile sizes bm x bn, chunk kc, groups and phases per block, grid,
// shared memory, ring stages, load paths, resident groups) comes from
// kernel.py::plan_launch; a plan that does not match this file's
// constants and rules is refused.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int cim_mvm_tiles_launch(const void* x, const void* w, void* out,
                                    int T, int M, int R, int C, int n_p,
                                    int n_s, int db, int cb, int pr,
                                    int adc_max, int elem_bytes, int bm,
                                    int bn, int kc, int gpb, int ppb,
                                    int grid_x, int grid_y, int smem,
                                    int stages, int x_tma, int w_tma,
                                    int resident, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = (R + pr - 1) / pr;
  if (elem_bytes == 1) {
    const int n_ct = (C + BN - 1) / BN;
    const int splits = ((n_groups + gpb - 1) / gpb) * ((n_p + ppb - 1) / ppb);
    const bool xt = x_takes_tma(x, R, pr), wt = w_takes_tma(w, C);
    if (bm != BM || bn != BN || kc != KC || x_tma != xt || w_tma != wt ||
        smem != wgmma_smem(xt, wt) || stages != ring_stages(xt, wt) ||
        resident != ((pr + KC - 1) / KC <= stages) || n_p > 8 ||
        n_p % ppb != 0 ||
        n_s > MAX_S || db > 8 || cb > 8 ||
        grid_x != ((M + BM - 1) / BM) * n_ct || grid_y != splits)
      return (int)cudaErrorInvalidValue;
    alignas(64) CUtensorMap xm = {}, wm = {};
    if (xt && !encode_3d(&xm, x, T, M, R, KC, BM, true))
      return (int)cudaErrorInvalidValue;
    if (wt && !encode_3d(&wm, w, T, R, C, BN, KC, false))
      return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (xt && wt)
      err = launch_live<true, true>(xm, wm, x, w, out, T, M, R, C, n_p, n_s,
                                    db, cb, pr, adc_max, gpb, ppb, grid_x,
                                    grid_y, resident, s);
    else if (xt)
      err = launch_live<true, false>(xm, wm, x, w, out, T, M, R, C, n_p,
                                     n_s, db, cb, pr, adc_max, gpb, ppb,
                                     grid_x, grid_y, resident, s);
    else if (wt)
      err = launch_live<false, true>(xm, wm, x, w, out, T, M, R, C, n_p,
                                     n_s, db, cb, pr, adc_max, gpb, ppb,
                                     grid_x, grid_y, resident, s);
    else
      err = launch_live<false, false>(xm, wm, x, w, out, T, M, R, C, n_p,
                                      n_s, db, cb, pr, adc_max, gpb, ppb,
                                      grid_x, grid_y, resident, s);
    return (int)err;
  }
  if (elem_bytes == 4) {
    const int n_ct = (C + CC_TILE - 1) / CC_TILE;
    if (bm != CC_TILE || bn != CC_TILE || kc < 1 || kc > pr ||
        smem != 2 * CC_TILE * kc * 4 || smem > CC_SMEM_BUDGET ||
        gpb != n_groups || ppb != n_p ||
        grid_x != ((M + CC_TILE - 1) / CC_TILE) * n_ct || grid_y != 1)
      return (int)cudaErrorInvalidValue;
    cudaError_t err =
        allow_smem(cuda_core_kernel, CC_SMEM_BUDGET, cc_smem_set);
    if (err != cudaSuccess) return (int)err;
    cuda_core_kernel<<<dim3(grid_x, 1, T), CC_THREADS, smem, s>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
        static_cast<int32_t*>(out), M, R, C, n_p, n_s, db, cb, pr, adc_max,
        kc);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Mean host microseconds of encoding x's tensor map for a (T,M,R) launch,
// over `reps` encodings (what every TMA launch pays on the host); -1 when
// the map cannot be encoded.
extern "C" double cim_mvm_encode_us(const void* x, int T, int M, int R,
                                    int reps) {
  alignas(64) CUtensorMap map = {};
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!encode_3d(&map, x, T, M, R, KC, BM, true)) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() /
         (reps > 0 ? reps : 1);
}
