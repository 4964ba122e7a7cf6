// The mix terms of one (src, dst) block pair as a signed gather, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package applies the mix terms (spin
// exchange, pair hopping, superc pairing) as dense or COO jnp products
// (dmft_ed_tpu/hamiltonian.py apply_op), which XLA runs as GEMMs or
// scatters. The port's plain version (kernels/mix_gather.py
// `mix_gather_plain`) is index gathers over the same tables; this kernel
// does the same arithmetic in one pass and its result is bit-identical to
// that version's.
//
// What it computes. Each term l of the pair is coeff_l * (B_l ⊗ A_l),
// B_l on the dw factor (rows) and A_l on the up factor (columns), where
// both are signed partial permutations: at most one ±1 in every row and
// in every column. hamiltonian.make_matvec_op stores, per term,
//     dsrc[l, r]  the source row of destination row r, or -1;
//     dwt[l, r]   its sign times coeff_l (exact: a sign flip);
//     usrc[l, c]  the source column of destination column c, or -1;
//     usg[l, c]   its sign (±1);
// and `rows`, the R destination rows that some term writes. Then, for
// every (r in rows, c) and every leading index b,
//     acc = Σ_l (dwt[l, r] * usg[l, c]) * V[b, dsrc[l, r], usrc[l, c]]
// over the terms with both sources, in term order, and
//     Y[b, r, c] = Y[b, r, c] + acc
// in place where some term has both sources (the rest of a compact row is
// written back unchanged; other rows are not touched). Every operation is an
// _rn intrinsic and the file is built with -fmad=false
// (kernels/_build.py), so nothing is contracted: each product rounds once
// and then adds, as the dense product coeff * (B V A^T) followed by the
// add to Y does. Where one term reaches an entry (the Kanamori terms of
// the Hund operator), the result is bitwise that of the dense path.
//
// Bound on this card: memory. At the Hund operator's (7,7) sector
// (3432 x 3432 block, four terms of 853,776 entries each, disjoint
// destinations) the least traffic is the distinct entries of V read and of
// Y written, 54.6 MB (benchmark/roofline_mix.py), 16.3 us at 3.35 TB/s.
// This kernel also reads the Y entries it updates, and the terms' entries
// interleave along a row (a Kanamori term's columns are the states whose
// two impurity bits differ, every other state or so), so it moves whole
// 32-byte sectors of the 1848 compact rows: ~2 x 51 MB of Y and ~51 MB of
// V, ~45 us at 3.35 TB/s. The design moves each of those sectors once:
//   * a CTA of 128 threads owns a 128-column tile and walks 4 compact
//     rows; it stages the rows' side of the first 8 terms (dsrc, dwt) in
//     shared memory, and a thread owns one column and reads that column's
//     side (usrc, usg) once into registers. A row's source is the same on
//     every thread, so a term without one costs a uniform branch and no
//     load: few memory instructions per entry, which at ~4 bytes moved per
//     instruction would otherwise take as long to issue as the bytes take
//     to move;
//   * Y is read and written whole along each compact row, coalesced
//     (entries that no term reaches are written back unchanged: the terms'
//     entries interleave, so a partial write moves the same sectors and
//     costs more), and rows outside the compact list are not touched: no
//     new tensor, no atomics, no zero fill;
//   * a hop operator c+_a c_b maps basis states by adding 2^a - 2^b, which
//     keeps their order, so usrc rises with c (at the Hund operator's
//     impurity bits, c -> c +- 1) and a warp's gathers of V fall in the
//     sectors of one source row that the row's other term reads too;
//   * the row loop is unrolled by 2 with V and Y declared not to alias, so
//     each thread keeps two rows' loads in flight;
//   * leading batch indices ride on the grid's z axis (strided loop).
// No synchronisation, no host read, no allocation: safe inside a CUDA
// graph. V and Y must not overlap (the wrapper refuses one storage).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int COLS = 128;     // threads of a CTA: one column each
constexpr int ROWS = 4;       // compact rows a CTA walks through
constexpr int MAXL = 8;       // terms whose column tables stay in registers

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// One term's contribution to an entry: the rounded product, accumulated in
// term order. `sr` is the row's source (the same on every thread of the
// CTA, so the branch on it is uniform); the load of V is predicated on
// the column's source.
template <typename T>
__device__ __forceinline__ void term(const T* __restrict__ v, long long v_rs,
                                     int sr, T dw, int sc, T sg, T& acc,
                                     bool& any) {
  if (sc < 0) return;
  const T p = mul_rn(mul_rn(dw, sg), __ldg(v + sr * v_rs + sc));
  acc = any ? add_rn(acc, p) : p;
  any = true;
}

template <typename T>
__global__ void __launch_bounds__(COLS)
    mix_gather_kernel(const T* __restrict__ V, long long v_bs, long long v_rs,
                      T* __restrict__ Y, long long y_bs, long long y_rs,
                      int nb, const int* __restrict__ dsrc,
                      const T* __restrict__ dwt, const int* __restrict__ usrc,
                      const T* __restrict__ usg, const int* __restrict__ rows,
                      int R, int L, int ddw, int dup) {
  // the CTA's rows and their side of the first MAXL terms, staged once
  __shared__ int s_r[ROWS];
  __shared__ int s_sr[MAXL][ROWS];
  __shared__ T s_dw[MAXL][ROWS];
  const int r0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, R - r0);
  const int lk = min(L, MAXL);
  for (int k = threadIdx.x; k < ROWS * (lk + 1); k += COLS) {
    const int i = k % ROWS, l = k / ROWS - 1;
    if (i >= nr) continue;
    const int r = __ldg(rows + r0 + i);
    if (l < 0) {
      s_r[i] = r;
    } else {
      s_sr[l][i] = __ldg(dsrc + static_cast<long long>(l) * ddw + r);
      s_dw[l][i] = __ldg(dwt + static_cast<long long>(l) * ddw + r);
    }
  }
  __syncthreads();
  const int c = blockIdx.x * COLS + threadIdx.x;
  if (c >= dup) return;
  // the column's side of the first MAXL terms, read once
  int sc[MAXL];
  T sg[MAXL];
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    sc[l] = l < L ? __ldg(usrc + static_cast<long long>(l) * dup + c) : -1;
    sg[l] = l < L ? __ldg(usg + static_cast<long long>(l) * dup + c) : T(0);
  }
  for (int b = blockIdx.z; b < nb; b += gridDim.z) {
    const T* v = V + b * v_bs;
    T* y = Y + b * y_bs;
#pragma unroll 2
    for (int i = 0; i < nr; ++i) {
      T* yp = y + s_r[i] * y_rs + c;
      const T y0 = *yp;
      T acc = T(0);
      bool any = false;
#pragma unroll
      for (int l = 0; l < MAXL; ++l) {
        if (l < lk) {
          const int sr = s_sr[l][i];
          if (sr >= 0) term(v, v_rs, sr, s_dw[l][i], sc[l], sg[l], acc, any);
        }
      }
      for (int l = MAXL; l < L; ++l) {
        const long long ld = static_cast<long long>(l) * ddw + s_r[i];
        const int sr = __ldg(dsrc + ld);
        if (sr < 0) continue;
        const long long lu = static_cast<long long>(l) * dup + c;
        term(v, v_rs, sr, __ldg(dwt + ld), __ldg(usrc + lu), __ldg(usg + lu),
             acc, any);
      }
      *yp = any ? add_rn(y0, acc) : y0;
    }
  }
}

template <typename T>
int launch(const void* V, long long v_bs, long long v_rs, void* Y,
           long long y_bs, long long y_rs, int nb, const void* dsrc,
           const void* dwt, const void* usrc, const void* usg,
           const void* rows, int R, int L, int ddw, int dup,
           cudaStream_t st) {
  const unsigned gx = static_cast<unsigned>((dup + COLS - 1) / COLS);
  const long long gy = (static_cast<long long>(R) + ROWS - 1) / ROWS;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned gz = static_cast<unsigned>(nb < 65535 ? nb : 65535);
  mix_gather_kernel<T><<<dim3(gx, static_cast<unsigned>(gy), gz), COLS, 0,
                         st>>>(
      static_cast<const T*>(V), v_bs, v_rs, static_cast<T*>(Y), y_bs, y_rs,
      nb, static_cast<const int*>(dsrc), static_cast<const T*>(dwt),
      static_cast<const int*>(usrc), static_cast<const T*>(usg),
      static_cast<const int*>(rows), R, L, ddw, dup);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer-sized integer).
// V: nb source blocks, element (b, i, j) at V[b * v_bs + i * v_rs + j];
// Y: nb destination blocks [ddw, dup], element (b, r, c) at
// Y[b * y_bs + r * y_rs + c], updated in place; dsrc, usrc int32 and dwt,
// usg of the vector's type, [L, ddw] and [L, dup]; rows int32 [R].
// double_prec: 1 for float64, 0 for float32. Returns 0 or the cudaError_t
// of the launch; never synchronises.
extern "C" int mix_gather_launch(const void* V, long long v_bs,
                                 long long v_rs, void* Y, long long y_bs,
                                 long long y_rs, int nb, const void* dsrc,
                                 const void* dwt, const void* usrc,
                                 const void* usg, const void* rows, int R,
                                 int L, int ddw, int dup, int double_prec,
                                 void* stream) {
  if (nb <= 0 || R <= 0 || L <= 0 || dup <= 0) return 0;
  if (R > ddw) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (double_prec)
    return launch<double>(V, v_bs, v_rs, Y, y_bs, y_rs, nb, dsrc, dwt, usrc,
                          usg, rows, R, L, ddw, dup, st);
  return launch<float>(V, v_bs, v_rs, Y, y_bs, y_rs, nb, dsrc, dwt, usrc,
                       usg, rows, R, L, ddw, dup, st);
}
