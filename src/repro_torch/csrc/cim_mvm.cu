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
// work.
//
// Two instantiations, chosen by the operand type (elem_bytes):
//
// uint8 operands (every plane in the low byte; all five arch presets):
// the tensor-core kernel, mma_kernel.
//   * Split.  Each (group g, phase p, slice s) term is clamped on its
//     own and then only added, so the work splits across blocks by
//     output tile (BM x BN of one crossbar tile t), by a range of row
//     groups and by a range of phases; a block keeps all S slices of its
//     phases.  The host's launch planner (kernel.py::plan_launch) picks
//     the ranges so that small outputs still fill the 132 SMs, and keeps
//     one range of each where the tiles alone fill the card.  Each block
//     adds its total into `out` (zeroed by the wrapper) with 32-bit
//     atomics: integer addition mod 2^32 in any order gives the same
//     bits, so results are identical run to run.
//   * Tensor cores.  The plane products run as
//     mma.sync.m16n8k32.row.col.s32.u8.u8.s32.  Each group's rows are
//     zero-padded to whole 32-row k-steps (zero rows leave the group's
//     analog sum unchanged, the plain version's own padding argument),
//     so a k-step never straddles two ADC reads.  One s32 fragment per
//     slice accumulates over the group's k-steps; at the group's end it
//     is clamped at adc_max, shifted by p*db + s*cb and added into a
//     uint32 running total.
//   * Extraction.  Raw operand bytes are staged, never planes: a 32-bit
//     word holds 4 consecutive k of one row (x) or one column (w), and
//     (word >> p*db) & ((2^db - 1) * 0x01010101) is the packed u8 plane
//     of those 4 k in one shift and one AND.  No bit of a neighbouring
//     byte reaches the mask because p*db + db <= 8.  One raw fragment
//     thus feeds every plane extracted from it.  The mma's B operand
//     wants 4 consecutive k of one column per register, so w's bytes
//     are gathered column-wise out of its row-major stage.
//   * Staging.  k-chunks of KC raw bytes pass through a STAGES-deep
//     shared-memory ring.  Where rows (x) or columns (w) are 16-byte
//     aligned the ring is filled with cp.async (zero-fill past the
//     group's end, M and C), overlapping the next chunks' copies with
//     this chunk's mma; otherwise (R = 147, C = 488, ...) the chunk is
//     loaded byte by byte.  Ragged M, C and R are masked here; the host
//     pads nothing.
//   * What bounds it now: the mma.sync throughput and the ALU work of
//     the extraction beside it (about 2 ALU and 0.75 shared-memory
//     instructions per mma), and atomics and restaging (each block
//     restages its groups once per phase) on the small grids.  wgmma,
//     TMA and warp specialisation are the next levers.
//
// int32 operands (a plane past the low byte; no preset, only sweep
// cases): cuda_core_kernel, the first port's CUDA-core body.  A block
// owns a 64 x 64 output tile, walks all groups and (p, s) pairs, stages
// a group as stored int32 and extracts planes in registers; int32 MACs,
// clamp, shift-add, plain stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------ tensor-core instantiation
// Tile constants; kernel.py's planner holds the same numbers and the
// launch refuses a plan made for others.
constexpr int BM = 64;             // output rows per block
constexpr int BN = 32;             // output columns per block
constexpr int KC = 128;            // k rows per staged chunk
constexpr int STAGES = 3;          // chunks in flight
constexpr int KSTEP = 32;          // k of one mma
constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M / 16;   // m16 fragments per warp
constexpr int WN = BN / WARPS_N / 8;    // n8 fragments per warp
constexpr int MAX_S = 8;                // slices of a uint8 weight
constexpr int XSTR = KC + 16;      // bytes per staged x row: conflict-free
constexpr int WSTR = BN + 16;      // bytes per staged w row
constexpr int X_STAGE = BM * XSTR;
constexpr int W_STAGE = KC * WSTR;
constexpr int MMA_SMEM = STAGES * (X_STAGE + W_STAGE);

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows of group g (the last group may be short).
__device__ __forceinline__ int group_len(int g, int R, int pr) {
  return min(pr, R - g * pr);
}

__device__ __forceinline__ int group_chunks(int g, int R, int pr) {
  const int ksteps = (group_len(g, R, pr) + KSTEP - 1) / KSTEP;
  return (ksteps * KSTEP + KC - 1) / KC;
}

// Position in a block's chunk sequence: phase, group, chunk of group.
struct Cursor {
  int p, g, ch;
  __device__ void advance(int g_begin, int g_end, int R, int pr) {
    if (++ch == group_chunks(g, R, pr)) {
      ch = 0;
      if (++g == g_end) {
        g = g_begin;
        ++p;
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS)
mma_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
           uint32_t* __restrict__ out, int M, int R, int C, int n_p,
           int n_s, int db, int cb, int pr, int adc_max, int gpb, int ppb,
           int x_vec, int w_vec) {
  extern __shared__ __align__(16) uint8_t smem[];

  // which output tile, groups and phases this block owns
  const int n_ct = (C + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_ct) * BM;
  const int c0 = (blockIdx.x % n_ct) * BN;
  const int p_splits = (n_p + ppb - 1) / ppb;
  const int n_groups = (R + pr - 1) / pr;
  const int g_begin = (blockIdx.y / p_splits) * gpb;
  const int g_end = min(n_groups, g_begin + gpb);
  const int p_begin = (blockIdx.y % p_splits) * ppb;
  const int p_end = min(n_p, p_begin + ppb);
  const int t = blockIdx.z;
  const uint8_t* xt = x + (size_t)t * M * R;
  const uint8_t* wt = w + (size_t)t * R * C;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;     // mma fragment coordinates
  const int wrow = (warp / WARPS_N) * (WM * 16);
  const int wcol = (warp % WARPS_N) * (WN * 8);
  // a warp whose rows or columns all lie past M or C computes nothing
  const bool active = m0 + wrow < M && c0 + wcol < C;

  int chunks_per_phase = 0;
  for (int g = g_begin; g < g_end; ++g)
    chunks_per_phase += group_chunks(g, R, pr);
  const int total = (p_end - p_begin) * chunks_per_phase;

  // fill ring slot `slot` with chunk `ch` of group `g` (raw bytes; rows
  // past the group's end, M or C read as 0)
  auto stage = [&](const Cursor& at, int slot) {
    uint8_t* xs = smem + slot * X_STAGE;
    uint8_t* ws = smem + STAGES * X_STAGE + slot * W_STAGE;
    const int k0 = at.g * pr + at.ch * KC;
    const int kv = min(KC, at.g * pr + group_len(at.g, R, pr) - k0);
    if (x_vec) {
      for (int i = tid; i < BM * (KC / 16); i += THREADS) {
        const int row = i / (KC / 16), k = (i % (KC / 16)) * 16;
        const int m = m0 + row;
        const int n = (m < M) ? max(0, min(16, kv - k)) : 0;
        cp_async16(xs + row * XSTR + k,
                   n ? xt + (size_t)m * R + k0 + k : xt, n);
      }
    } else {
      for (int i = tid; i < BM * KC; i += THREADS) {
        const int row = i / KC, k = i % KC;
        const int m = m0 + row;
        xs[row * XSTR + k] =
            (m < M && k < kv) ? xt[(size_t)m * R + k0 + k] : uint8_t(0);
      }
    }
    if (w_vec) {
      for (int i = tid; i < KC * (BN / 16); i += THREADS) {
        const int row = i / (BN / 16), c = (i % (BN / 16)) * 16;
        const int n = (row < kv && c0 + c < C) ? 16 : 0;
        cp_async16(ws + row * WSTR + c,
                   n ? wt + (size_t)(k0 + row) * C + c0 + c : wt, n);
      }
    } else {
      for (int i = tid; i < KC * BN; i += THREADS) {
        const int row = i / BN, c = i % BN;
        ws[row * WSTR + c] = (row < kv && c0 + c < C)
                                 ? wt[(size_t)(k0 + row) * C + c0 + c]
                                 : uint8_t(0);
      }
    }
  };

  int acc[MAX_S][WM][WN][4];
  uint32_t tot[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tot[i][j][r] = 0;
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) acc[s][i][j][r] = 0;
      }
  const uint32_t pmask = ((1u << db) - 1) * 0x01010101u;
  const uint32_t smask = ((1u << cb) - 1) * 0x01010101u;

  // ahead: the next chunk to stage; now: the chunk computed on
  Cursor ahead{p_begin, g_begin, 0}, now{p_begin, g_begin, 0};
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < total) {
      stage(ahead, i);
      ahead.advance(g_begin, g_end, R, pr);
    }
    cp_async_commit();
  }

#pragma unroll 1
  for (int i = 0; i < total; ++i) {
    cp_async_wait_ring();
    __syncthreads();   // chunk i landed; every warp is done with i - 1
    if (i + STAGES - 1 < total) {
      stage(ahead, (i + STAGES - 1) % STAGES);
      ahead.advance(g_begin, g_end, R, pr);
    }
    cp_async_commit();

    if (active) {
      const uint8_t* xs = smem + (i % STAGES) * X_STAGE;
      const uint8_t* ws = smem + STAGES * X_STAGE + (i % STAGES) * W_STAGE;
      const int k0 = now.g * pr + now.ch * KC;
      const int kv = min(KC, now.g * pr + group_len(now.g, R, pr) - k0);
      const int nks = (kv + KSTEP - 1) / KSTEP;
      const int xsh = now.p * db;
#pragma unroll
      for (int ks = 0; ks < KC / KSTEP; ++ks) {
        if (ks >= nks) break;
        uint32_t a[WM][4];
#pragma unroll
        for (int fm = 0; fm < WM; ++fm) {
          const uint8_t* base =
              xs + (wrow + fm * 16 + gid) * XSTR + ks * KSTEP + tig * 4;
          a[fm][0] = *reinterpret_cast<const uint32_t*>(base);
          a[fm][1] = *reinterpret_cast<const uint32_t*>(base + 8 * XSTR);
          a[fm][2] = *reinterpret_cast<const uint32_t*>(base + 16);
          a[fm][3] =
              *reinterpret_cast<const uint32_t*>(base + 8 * XSTR + 16);
#pragma unroll
          for (int r = 0; r < 4; ++r) a[fm][r] = (a[fm][r] >> xsh) & pmask;
        }
        uint32_t b[WN][2];
#pragma unroll
        for (int fn = 0; fn < WN; ++fn) {
          const uint8_t* col =
              ws + (ks * KSTEP + tig * 4) * WSTR + wcol + fn * 8 + gid;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint8_t* q = col + h * 16 * WSTR;
            b[fn][h] = (uint32_t)q[0] | ((uint32_t)q[WSTR] << 8) |
                       ((uint32_t)q[2 * WSTR] << 16) |
                       ((uint32_t)q[3 * WSTR] << 24);
          }
        }
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) {
          if (s < n_s) {
#pragma unroll
            for (int fn = 0; fn < WN; ++fn) {
              const uint32_t bs[2] = {(b[fn][0] >> (s * cb)) & smask,
                                      (b[fn][1] >> (s * cb)) & smask};
#pragma unroll
              for (int fm = 0; fm < WM; ++fm)
                mma_u8(acc[s][fm][fn], a[fm], bs);
            }
          }
        }
      }
      // the group's last chunk: one analog read per (p, s), ADC clamp,
      // digital shift-add (uint32 wraps like the plain version's int32)
      if (now.ch == group_chunks(now.g, R, pr) - 1) {
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) {
          if (s < n_s) {
            const int sh = now.p * db + s * cb;
#pragma unroll
            for (int fm = 0; fm < WM; ++fm)
#pragma unroll
              for (int fn = 0; fn < WN; ++fn)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  tot[fm][fn][r] += (uint32_t)min(acc[s][fm][fn][r], adc_max)
                                    << sh;
                  acc[s][fm][fn][r] = 0;
                }
          }
        }
      }
    }
    now.advance(g_begin, g_end, R, pr);
  }
  asm volatile("cp.async.wait_all;\n" ::);

  if (!active) return;
#pragma unroll
  for (int fm = 0; fm < WM; ++fm)
#pragma unroll
    for (int fn = 0; fn < WN; ++fn)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wrow + fm * 16 + gid + (r >= 2 ? 8 : 0);
        const int c = c0 + wcol + fn * 8 + tig * 2 + (r & 1);
        if (m < M && c < C)
          atomicAdd(out + ((size_t)t * M + m) * C + c, tot[fm][fn][r]);
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

bool mma_smem_set[MAX_DEVICES] = {};
bool cc_smem_set[MAX_DEVICES] = {};

}  // namespace

// x: (T,M,R), w: (T,R,C), out: (T,M,C) int32, all contiguous on the
// current device, out zeroed; elem_bytes is 1 (uint8 operands: the
// tensor-core kernel) or 4 (int32: the CUDA-core kernel).  The launch
// plan (tile sizes bm x bn, chunk kc, groups and phases per block, grid,
// shared memory) comes from kernel.py::plan_launch; a plan that does not
// match this file's constants is refused.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int cim_mvm_tiles_launch(const void* x, const void* w, void* out,
                                    int T, int M, int R, int C, int n_p,
                                    int n_s, int db, int cb, int pr,
                                    int adc_max, int elem_bytes, int bm,
                                    int bn, int kc, int gpb, int ppb,
                                    int grid_x, int grid_y, int smem,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = (R + pr - 1) / pr;
  if (elem_bytes == 1) {
    const int n_ct = (C + BN - 1) / BN;
    const int splits = ((n_groups + gpb - 1) / gpb) * ((n_p + ppb - 1) / ppb);
    if (bm != BM || bn != BN || kc != KC || smem != MMA_SMEM ||
        n_s > MAX_S || db > 8 || cb > 8 ||
        grid_x != ((M + BM - 1) / BM) * n_ct || grid_y != splits)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(mma_kernel, MMA_SMEM, mma_smem_set);
    if (err != cudaSuccess) return (int)err;
    const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      R % 16 == 0 && pr % 16 == 0;
    const int w_vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                      C % 16 == 0;
    mma_kernel<<<dim3(grid_x, grid_y, T), THREADS, smem, s>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
        static_cast<uint32_t*>(out), M, R, C, n_p, n_s, db, cb, pr,
        adc_max, gpb, ppb, x_vec, w_vec);
    return (int)cudaGetLastError();
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
