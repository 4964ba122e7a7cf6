// Ozaki digit extraction for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package slices its operands with plain
// jnp (dmft_ed_tpu/ozaki.py `_digits_list`), which XLA fuses. The port's
// plain version of that arithmetic (kernels/digit_split.py `_digits_list`)
// runs as ~12 elementwise torch operations per digit over f32/f64
// temporaries of the whole operand; this kernel does the same arithmetic
// in one pass over the operand, and its result is bit-identical to that
// version's.
//
// What it computes, for an f64 operand A and P digits of `bits` bits, with
// one power-of-two scale per row (left operand) or per column (right):
//     a32 = f32(A) (round to nearest)
//     m   = max |a32| along the scale axis
//     E   = ceil(log2 m) + 1 from the IEEE bit fields (m = 0 included)
//     inv = 2^-E, S64 = f64(2^E), the biased exponent clamped to [1, 254]
//     t   = a32 * inv;  c = f32(A - f64(t) * S64) * inv
// then P rounds of
//     y = t * 2^bits; cB = c * 2^bits; (s, e2) = TwoSum(y, cB)
//     q = rint(s) (half to even); d = s - q; (t, c) = TwoSum(d, e2)
//     digit = clamp(q, -127, 127) as int8
// Every step is an _rn intrinsic and the file is built with -fmad=false
// (kernels/_build.py), no fast math and no flush to zero, so nothing is
// contracted or reassociated. The maximum is exact in any order.
//
// Layout: both digit stacks are K-major with the contraction axis padded
// to Kp (a multiple of 16) and zero past the true k, as
// kernels/digit_matmul.py reads them:
//   * left  A [m, k], per-row scales:    out [P, m, Kp], scales [m];
//   * right A [k, n], per-column scales: out [P, n, Kp] (A's digits
//     transposed), scales [n].
// A is read through its element strides (s0, s1), any layout.
//
// Bound on this card: memory. The least traffic is the f64 operand read
// once and the P int8 planes written once (and 8 bytes of scale per row or
// column): at the main path's 3432 x 3432 Krylov vector, P = 5, that is
// 94.2 MB + 59.0 MB, 0.046 ms at 3.35 TB/s. The arithmetic, ~110
// instructions per element at P = 5, takes about as long to issue (~40 us
// there), so the kernels stay near twice the bound. What the design does
// about it:
//   * left operand (digit_split_rows): a team of T threads (32..256,
//     chosen from Kp so that one team chunk of 16 T columns covers the row
//     where it can) owns one row; a CTA of 256 threads holds 256 / T rows.
//     The team reads the row once, coalesced, keeping the first chunk in
//     registers (16 f64 a thread), reduces the row maximum with shuffles
//     and shared memory, writes the digits of a chunk byte by byte into
//     P shared-memory planes and then stores them with 16-byte stores,
//     pad columns included as zeros. A row longer than one chunk is read
//     again for its later chunks (from L2). So the operand is read from
//     device memory once;
//   * right operand (digit_split_colmax, digit_split_cols): the scale
//     axis is the contraction axis, which the output stores transposed.
//     A first pass takes the column maxima of 128-row strips, coalesced
//     along n, into a [strips, n] scratch (no atomics, nothing to zero);
//     the second pass combines a 64-column tile's strip maxima, then works
//     through 64 x 64 sub-tiles: each thread reads 4 x 4 elements, coalesced
//     along n, packs 4 consecutive k digits of one column into a word in
//     shared memory (rows of 17 words: conflict free) and the tile leaves
//     as 64-byte runs of buf[p, j, :], coalesced. The operand is read
//     twice (about 0.03 ms above the bound at 3432 x 3432);
//   * no host synchronise: 2^bits is an argument, the kernels launch on
//     the caller's stream and allocate nothing (the wrapper passes the
//     scratch).
// Measured on an H100 (PERF.md): at 3432 x 3432, P = 5, the left split
// takes 0.097-0.100 ms and the right one 0.136-0.146 ms (first pass 0.038);
// 128-row strips beat 256 and 512, and capping the registers for four
// CTAs per SM gained nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_EPT = 16;                      // elements a thread, chunk
constexpr int ROW_CHUNK = THREADS * ROW_EPT;     // 4096 bytes a plane
constexpr int COL_TN = 64;                       // columns of a CTA tile
constexpr int COL_TK = 64;                       // rows of a sub-tile
constexpr int COL_SUB = 2;                       // sub-tiles of a CTA
constexpr int STRIP = COL_TK * COL_SUB;          // 128 rows
constexpr int WORDS = COL_TK / 4 + 1;            // 17: 16 words + 1 pad

__device__ __forceinline__ unsigned abs_bits(double a) {
  return __float_as_uint(fabsf(__double2float_rn(a)));
}

__device__ __forceinline__ float pow2_f32(int e) {
  const int eb = min(max(e + 127, 1), 254);
  return __uint_as_float(static_cast<unsigned>(eb) << 23);
}

// inv = 2^-E and S64 = f64(2^E) from the maximum's bit pattern.
__device__ __forceinline__ void scale_of(unsigned mbits, float& inv,
                                         double& s64) {
  const int expo = static_cast<int>((mbits >> 23) & 0xFFu) - 127;
  const int E = expo + ((mbits & 0x7FFFFFu) != 0u ? 1 : 0) + 1;
  inv = pow2_f32(-E);
  s64 = static_cast<double>(pow2_f32(E));
}

__device__ __forceinline__ void first_pair(double a, float inv, double s64,
                                           float& t, float& c) {
  t = __fmul_rn(__double2float_rn(a), inv);
  const double r = __dsub_rn(a, __dmul_rn(static_cast<double>(t), s64));
  c = __fmul_rn(__double2float_rn(r), inv);
}

__device__ __forceinline__ unsigned next_digit(float& t, float& c,
                                               float step) {
  const float y = __fmul_rn(t, step);
  const float cb = __fmul_rn(c, step);
  const float s = __fadd_rn(y, cb);
  const float bp = __fsub_rn(s, y);
  const float e2 = __fadd_rn(__fsub_rn(y, __fsub_rn(s, bp)),
                             __fsub_rn(cb, bp));
  const float q = rintf(s);
  const float d = __fsub_rn(s, q);
  const float t2 = __fadd_rn(d, e2);
  const float bp2 = __fsub_rn(t2, d);
  c = __fadd_rn(__fsub_rn(d, __fsub_rn(t2, bp2)), __fsub_rn(e2, bp2));
  t = t2;
  const int qi = __float2int_rz(fminf(fmaxf(q, -127.0f), 127.0f));
  return static_cast<unsigned>(qi) & 0xFFu;
}

// Left operand: a team of T threads a row, THREADS / T rows a CTA. Dynamic
// shared memory: P planes of ROW_CHUNK bytes.
__global__ void __launch_bounds__(THREADS)
digit_split_rows(const double* __restrict__ A, long long s0, long long s1,
                 int m, int k, int Kp, int P, float step, int T,
                 int8_t* __restrict__ out, double* __restrict__ scales) {
  extern __shared__ __align__(16) unsigned char planes[];
  __shared__ unsigned red[THREADS / 32];
  const int tid = threadIdx.x;
  const int team = tid / T, lt = tid % T;
  const int row = blockIdx.x * (THREADS / T) + team;
  const bool live = row < m;
  const double* a = A + static_cast<long long>(live ? row : 0) * s0;
  const int chunk = ROW_EPT * T;
  unsigned char* mine = planes + team * chunk;

  // the first chunk into registers; the maximum over the whole row
  double x[ROW_EPT];
  unsigned mx = 0u;
#pragma unroll
  for (int s = 0; s < ROW_EPT; ++s) {
    const int c = lt + s * T;
    x[s] = (live && c < k) ? a[c * s1] : 0.0;
    mx = max(mx, abs_bits(x[s]));
  }
  for (int c = chunk + lt; live && c < k; c += T)
    mx = max(mx, abs_bits(a[c * s1]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (T > 32) {
    if ((tid & 31) == 0) red[tid >> 5] = mx;
    __syncthreads();
    const int w0 = (team * T) >> 5;
    for (int w = 0; w < T / 32; ++w) mx = max(mx, red[w0 + w]);
  }
  float inv;
  double s64;
  scale_of(mx, inv, s64);
  if (live && lt == 0) scales[row] = s64;

  for (int c0 = 0; c0 < Kp; c0 += chunk) {
    if (c0 > 0) {
#pragma unroll
      for (int s = 0; s < ROW_EPT; ++s) {
        const int c = c0 + lt + s * T;
        x[s] = (live && c < k) ? a[c * s1] : 0.0;
      }
    }
#pragma unroll
    for (int s = 0; s < ROW_EPT; ++s) {
      unsigned char* dst = mine + lt + s * T;
      if (c0 + lt + s * T < k) {
        float t, c;
        first_pair(x[s], inv, s64, t, c);
        for (int p = 0; p < P; ++p)
          dst[p * ROW_CHUNK] =
              static_cast<unsigned char>(next_digit(t, c, step));
      } else {
        for (int p = 0; p < P; ++p) dst[p * ROW_CHUNK] = 0;
      }
    }
    __syncthreads();
    if (live) {
      const int nvec = min(chunk, Kp - c0) / 16;
      for (int p = 0; p < P; ++p) {
        const uint4* src =
            reinterpret_cast<const uint4*>(mine + p * ROW_CHUNK);
        uint4* dst = reinterpret_cast<uint4*>(
            out + (static_cast<long long>(p) * m + row) * Kp + c0);
        for (int g = lt; g < nvec; g += T) dst[g] = src[g];
      }
    }
    __syncthreads();
  }
}

// Right operand, first pass: the maximum bit pattern of |f32(A[i, j])| over
// the rows of one STRIP, for 64 columns a CTA: partial[strip, j].
__global__ void __launch_bounds__(THREADS)
digit_split_colmax(const double* __restrict__ A, long long s0, long long s1,
                   int k, int n, unsigned* __restrict__ partial) {
  __shared__ unsigned red[THREADS / COL_TN][COL_TN];
  const int tx = threadIdx.x % COL_TN, ty = threadIdx.x / COL_TN;
  const int j = blockIdx.x * COL_TN + tx;
  const int i0 = blockIdx.y * STRIP;
  unsigned mx = 0u;
  if (j < n) {
    const double* a = A + j * s1;
    const int i1 = min(i0 + STRIP, k);
#pragma unroll 8
    for (int i = i0 + ty; i < i1; i += THREADS / COL_TN)
      mx = max(mx, abs_bits(a[i * s0]));
  }
  red[ty][tx] = mx;
  __syncthreads();
  if (ty == 0 && j < n) {
    for (int r = 1; r < THREADS / COL_TN; ++r) mx = max(mx, red[r][tx]);
    partial[static_cast<long long>(blockIdx.y) * n + j] = mx;
  }
}

// Right operand, second pass: a 64-column tile over STRIP rows, in 64 x 64
// sub-tiles. Dynamic shared memory: P planes of 64 rows x WORDS words.
__global__ void __launch_bounds__(THREADS)
digit_split_cols(const double* __restrict__ A, long long s0, long long s1,
                 int k, int n, int Kp, int P, float step,
                 const unsigned* __restrict__ partial, int strips,
                 int8_t* __restrict__ out, double* __restrict__ scales) {
  extern __shared__ __align__(16) unsigned words[];
  __shared__ float sinv[COL_TN];
  __shared__ double ss64[COL_TN];
  const int tid = threadIdx.x;
  const int tx = tid % COL_TN, ty = tid / COL_TN;
  const int j0 = blockIdx.x * COL_TN;
  const int j = j0 + tx;
  if (ty == 0) {
    unsigned mx = 0u;
    if (j < n)
      for (int s = 0; s < strips; ++s)
        mx = max(mx, partial[static_cast<long long>(s) * n + j]);
    float inv;
    double s64;
    scale_of(mx, inv, s64);
    sinv[tx] = inv;
    ss64[tx] = s64;
    if (blockIdx.y == 0 && j < n) scales[j] = s64;
  }
  __syncthreads();
  const float inv = sinv[tx];
  const double s64 = ss64[tx];
  const double* a = A + static_cast<long long>(j < n ? j : 0) * s1;
  for (int sub = 0; sub < COL_SUB; ++sub) {
    const int i0 = blockIdx.y * STRIP + sub * COL_TK;
    if (i0 >= Kp) break;
    // thread (tx, ty): rows i0 + 4 (ty + 4 r) + q, r, q = 0..3
    double x[16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + 4 * (ty + 4 * r) + q;
        x[4 * r + q] = (j < n && i < k) ? a[i * s0] : 0.0;
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float t[4], c[4];
      const int ib = i0 + 4 * (ty + 4 * r);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        first_pair(x[4 * r + q], inv, s64, t[q], c[q]);
      for (int p = 0; p < P; ++p) {
        unsigned w = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned d = next_digit(t[q], c[q], step);
          if (ib + q < k) w |= d << (8 * q);
        }
        words[(p * COL_TN + tx) * WORDS + ty + 4 * r] = w;
      }
    }
    __syncthreads();
    const int nw = min(COL_TK, Kp - i0) / 4;
    for (int p = 0; p < P; ++p)
      for (int idx = tid; idx < COL_TN * (COL_TK / 4); idx += THREADS) {
        const int jj = idx / (COL_TK / 4), w = idx % (COL_TK / 4);
        if (j0 + jj < n && w < nw)
          *reinterpret_cast<unsigned*>(
              out + (static_cast<long long>(p) * n + j0 + jj) * Kp + i0 +
              4 * w) = words[(p * COL_TN + jj) * WORDS + w];
      }
    __syncthreads();
  }
}

}  // namespace

// The row operand's team size: the least of 32..256 threads whose chunk of
// 16 T columns covers Kp, else 256.
static int team_size(int Kp) {
  int T = THREADS;
  while (T > 32 && ROW_EPT * (T / 2) >= Kp) T /= 2;
  return T;
}

// Number of STRIP-row strips of the right operand's first pass (the rows of
// the scratch `partial` the wrapper allocates).
extern "C" int digit_split_strips(int k) { return (k + STRIP - 1) / STRIP; }

// Launch on `stream` (a cudaStream_t passed as a pointer-sized integer).
// right == 0: A [rows, k] with per-row scales, out [P, rows, Kp];
// right == 1: A [k, rows] with per-column scales, out [P, rows, Kp], and
// `partial` a uint32 scratch of digit_split_strips(k) x rows.
// Returns 0 or the cudaError_t of the launches; never synchronises.
extern "C" int digit_split_launch(const void* A, long long s0, long long s1,
                                  int rows, int k, int Kp, int P, int bits,
                                  int right, void* out, void* scales,
                                  void* partial, void* stream) {
  if (rows <= 0) return 0;
  if (P < 1 || P > 7 || bits < 1 || bits > 7 || k < 1 || Kp < k ||
      Kp % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const double*>(A);
  auto* o = static_cast<int8_t*>(out);
  auto* sc = static_cast<double*>(scales);
  const float step = static_cast<float>(1 << bits);
  if (!right) {
    const int T = team_size(Kp);
    const int per = THREADS / T;
    const unsigned grid = static_cast<unsigned>((rows + per - 1) / per);
    digit_split_rows<<<grid, THREADS, P * ROW_CHUNK, st>>>(
        a, s0, s1, rows, k, Kp, P, step, T, o, sc);
    return static_cast<int>(cudaGetLastError());
  }
  const int strips = digit_split_strips(k);
  const int kstrips = (Kp + STRIP - 1) / STRIP;
  if (strips > 65535 || kstrips > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto* part = static_cast<unsigned*>(partial);
  const unsigned gx = static_cast<unsigned>((rows + COL_TN - 1) / COL_TN);
  digit_split_colmax<<<dim3(gx, strips), THREADS, 0, st>>>(a, s0, s1, k, rows,
                                                          part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  digit_split_cols<<<dim3(gx, kstrips), THREADS,
                     P * COL_TN * WORDS * sizeof(unsigned), st>>>(
      a, s0, s1, k, rows, Kp, P, step, part, strips, o, sc);
  return static_cast<int>(cudaGetLastError());
}
