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
// parallel_row rows, the rows of one analog read.
//
// Bound on the card: operands move (T*M*R + T*R*C) * elem + T*M*C*4
// bytes at 3.35 TB/s, and the work is 2*T*M*C*R*P*S plane operations,
// against 1979 TOPS of int8 tensor-core rate.  For the executor's
// shapes (R in the hundreds to thousands, P = S = 8 on jia-issc21) the
// operations bound by far: the data is tiny next to the P*S-fold plane
// work.
//
// Design (simple and right first; speed levers are later work):
//   * a block owns one BM x BC output tile of one crossbar tile t
//     (grid = (ceil(M/BM), ceil(C/BC), T)); ragged M and C edges are
//     masked in the kernel, so the host pads nothing;
//   * the block walks the row groups in order, in a loop — that loop
//     replaces the TPU kernel's sequential, accumulating innermost grid
//     axis, since Hopper blocks run in no order and carry nothing over;
//   * one group's x and w slices are staged in shared memory as the
//     stored integers; bit planes are extracted in registers, so the
//     (P|S)-fold plane layouts never exist in memory.  When a group is
//     longer than the staged chunk (int32 operands with a wide group)
//     the chunk is restaged for every (p, s) pair;
//   * per group and per (p, s): the integer dot in int32 CUDA-core MACs,
//     the clamp at adc_max, the shift-add into an int32 accumulator;
//   * rows past R contribute 0 (staged as zeros), so the ADC sees what
//     the plain version's zero padding gives it.
// Not done yet: AND + __popc for 1-bit planes, dp4a / int8 mma with each
// group zero-padded to k = 32, and keeping all P*S partial sums in
// registers to stage each group once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // output rows per block
constexpr int BC = 64;         // output columns per block
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int SMEM_BUDGET = 160 * 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
cim_mvm_tiles_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     int32_t* __restrict__ out, int M, int R, int C,
                     int n_p, int n_s, int db, int cb, int pr, int adc_max,
                     int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);          // [BM][kc]
  T* ws = xs + BM * kc;                             // [kc][BC]

  const int t = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BC;
  const T* xt = x + (size_t)t * M * R;
  const T* wt = w + (size_t)t * R * C;
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
          for (int i = tid; i < BM * kc; i += THREADS) {
            const int mm = i / kc, kk = i % kc;
            xs[i] = (m0 + mm < M && kk < klen)
                        ? xt[(size_t)(m0 + mm) * R + k0 + kk] : T(0);
          }
          for (int i = tid; i < kc * BC; i += THREADS) {
            const int kk = i / BC, cc = i % BC;
            ws[i] = (kk < klen && c0 + cc < C)
                        ? wt[(size_t)(k0 + kk) * C + c0 + cc] : T(0);
          }
          __syncthreads();
        }
        for (int kk = 0; kk < klen; ++kk) {
          int32_t xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[i] = ((int32_t)xs[(ty + 16 * i) * kc + kk] >> xsh) & xmask;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = ((int32_t)ws[kk * BC + tx + 16 * j] >> wsh) & wmask;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * wv[j];
        }
      }
      // one analog read per group: ADC clamp, then digital shift-add
      // (unsigned arithmetic wraps exactly like the plain version's int32)
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

// Raise the template's dynamic shared-memory ceiling to SMEM_BUDGET once
// per device; every launch stays within it.
template <typename T>
cudaError_t allow_smem_budget() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(cim_mvm_tiles_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BUDGET);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int T_, int M,
                   int R, int C, int n_p, int n_s, int db, int cb, int pr,
                   int adc_max, cudaStream_t stream) {
  int kc = SMEM_BUDGET / ((BM + BC) * (int)sizeof(T));
  if (kc > pr) kc = pr;
  const int smem = (BM + BC) * kc * (int)sizeof(T);
  cudaError_t err = allow_smem_budget<T>();
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, (C + BC - 1) / BC, T_);
  cim_mvm_tiles_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<int32_t*>(out), M, R, C, n_p, n_s, db, cb, pr, adc_max,
      kc);
  return cudaGetLastError();
}

}  // namespace

// x: (T,M,R), w: (T,R,C), out: (T,M,C) int32, all contiguous on the
// current device; elem_bytes is 1 (uint8 operands) or 4 (int32).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cim_mvm_tiles_launch(const void* x, const void* w, void* out,
                                    int T, int M, int R, int C, int n_p,
                                    int n_s, int db, int cb, int pr,
                                    int adc_max, int elem_bytes,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)launch<uint8_t>(x, w, out, T, M, R, C, n_p, n_s, db, cb, pr,
                                adc_max, s);
  if (elem_bytes == 4)
    return (int)launch<int32_t>(x, w, out, T, M, R, C, n_p, n_s, db, cb, pr,
                                adc_max, s);
  return (int)cudaErrorInvalidValue;
}
