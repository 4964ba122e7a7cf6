// Ozaki int8 digit matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: dmft_ed_tpu/pallas_kernels.py:37 `_digit_matmul_kernel`
// (launched by `digit_matmul_tiles`, wrapped by `matmul_fused`). The JAX
// package runs the same sum as the XLA composition in dmft_ed_tpu/ozaki.py
// (`_cat_groups` / `_pairwise` + `_group_combine`); this kernel follows that
// composition's schedule and epilogue exactly, so its result is
// bit-identical to the plain version in kernels/digit_matmul.py.
//
// What one block computes -- a tile of
//     out[i, j] = ((f64(hi) + f64(lo)) * rs[i]) * cs[j]
// where (hi, lo) is a TwoSum-compensated f32 pair accumulating, ascending
// in s = 0..P-1, the exact int32 digit products at scale 2^{-bits(s+2)}:
//   * concatenated schedule (pairwise == 0): one group sum
//         g_s = sum_{p+q=s} A_p . B_q
//     per s, exact in int32 while P*K*D^2 < 2^31 (ozaki._cat_safe);
//   * pairwise schedule (pairwise == 1): every (p, q) product, and every
//     kchunk-long piece of its contraction axis, enters the pair on its own
//     (ozaki._pairwise), in the order s, p, chunk.
// Each term g enters the pair as in ozaki._group_combine:
//     ghi = f32(g); glo = f32(g - int(ghi))          (lossless split)
//     x = ghi*sc; t = hi + x; bp = t - hi
//     err = (hi - (t - bp)) + (x - bp); hi = t; lo = (lo + err) + glo*sc
// Every step uses the _rn intrinsics (and the file is built with
// -fmad=false) so nothing is contracted into an FMA or reassociated: the
// error-free transform stays error-free. g is never cast to f32 whole:
// group sums reach ~2e7 > 2^24 at K=924, P=5. The int32 sums are exact in
// any order, so summing them on the tensor cores changes no bit.
//
// Layout: ad [P, M, Kp] and bd [P, N, Kp] int8, both K-major (row-major
// with the contraction axis last) and contiguous, Kp a multiple of 16 and
// zero past the true K; rs [M], cs [N] f64; out [M, N] f64. The 8-bit
// tensor-core instructions take both operands K-major only, and TMA needs
// 16-byte global strides: ozaki.py builds the stacks so, writing the right
// operand's digits transposed straight into its zero-padded buffer (no
// in-kernel byte transpose).
//
// Bound on this card: 2 * P(P+1)/2 * M*N*K int8 operations (true K, not
// Kp) over the 1,979 TOPS int8 tensor-core peak. At the main path's 924
// class (M=924, K=924, N=4096, P=5) that is 1.05e11 operations, 53 us,
// against ~54 MB of traffic, 16 us at 3.35 TB/s: operation-bound. What the
// design does about it:
//   * tensor cores: wgmma.mma_async m64n128k32 .s32.s8.s8 (never
//     .satfinite: the schedule keeps the sums exact, saturation would hide
//     a wrap), both operands from shared memory, 128B swizzle, K-major;
//   * operand feed: one producer warpgroup per CTA (one thread of it
//     issues) makes TMA loads of 128-byte-deep A and B tiles into a ring
//     of STAGES = 4 shared-memory stages, completed on mbarriers (full:
//     bytes arrived; empty: every consumer warpgroup of the cluster done
//     reading). Ragged M and N edges come from TMA's out-of-bounds zero
//     fill. The maps' contraction extent is the true K (row stride Kp),
//     so the same zero fill covers the k-tail: columns K..Kp-1 never
//     enter, whatever they hold, exactly as in the plain version;
//   * L2 feed: a 128x128 tile streams 15 x 8 k-tiles of 32 KB at the 924
//     class, ~1 GB per call from L2. Two CTAs along N form a cluster and
//     share the A tile: each loads its 64 rows and multicasts them to
//     both, so a CTA reads 24 KB per k-tile instead of 32;
//   * schedule: the producer streams k-tiles in the order (s, p, ktile),
//     A_p against B_{s-p}. Each group s starts with a wgmma at scale-d = 0
//     whose accumulator is output only; after its last the consumer waits
//     (wgmma.wait_group 0) and combines its int32 fragment into (hi, lo).
//     P=5 at K=924 is 15 * 8 = 120 k-tiles per output tile, so the ring
//     stays full across group boundaries;
//   * registers: the sum, hi and lo are 3 words per output, 192 per thread
//     of a 64x128 warpgroup tile. Two consumer warpgroups make a 128x128
//     CTA tile (8 x 32 = 256 tiles at 924x4096 on 132 SMs). With the
//     producer that is 3 warps per SM sub-partition, which caps every
//     thread at 168 registers (16,384 / 3 / 32, in steps of 8), and ptxas
//     keeps the consumers near that cap even after setmaxnreg gives them
//     232 (the producer 40). So lo lives in shared memory (64 KB, word
//     256 i + thread: no bank conflict); the sum and hi stay in registers.
//     As the sum is output only at each group's start, its registers are
//     free from the combine onwards. No wait of the consumers counts its
//     polls. ptxas reports no spill (PERF.md). Holding the pair in
//     registers spilled it around each combine, and a CTA of the two
//     warpgroups alone (255 registers, thread 0 the producer) was slower:
//     a producer that waits for the releases stalls its warpgroup;
//   * epilogue: f64 ((hi + lo) * rs) * cs with __dadd_rn / __dmul_rn,
//     straight from the fragment, masked at the ragged edges; each output
//     written once, 16 bytes per thread per column pair, full 32-byte
//     sectors per warp.
// Measured on an H100 (PERF.md): 4 stages beat 3, 5 and 6, and the 2-CTA
// cluster beats one CTA. Arriving once per warpgroup with the default
// (CTA-scope) semantics, and not per warp with .release.cluster, is what
// makes the cluster pay at all. A 2x2 cluster that shares B too, skipping
// the zero-fill k32 steps past Kp, and 256-byte-deep stages were all
// slower.
// Pairwise schedule: its chunk boundaries (kchunk, any length) do not fall
// on the 32-byte MMA depth, so it keeps the first kernel's __dp4a route on
// the same K-major layout, for pairwise == 1 only. The main path never
// takes it: it needs P*K*D^2 >= 2^31, K > 101,650 at 5x7.

#include <atomic>
#include <cstdint>
#include <functional>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void combine(float& hi, float& lo, int g,
                                        float sc) {
  const float ghi = __int2float_rn(g);
  const float glo = __int2float_rn(g - __float2int_rz(ghi));
  const float x = __fmul_rn(ghi, sc);
  const float t = __fadd_rn(hi, x);
  const float bp = __fsub_rn(t, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(t, bp)),
                              __fsub_rn(x, bp));
  hi = t;
  lo = __fadd_rn(__fadd_rn(lo, err), __fmul_rn(glo, sc));
}

__device__ __forceinline__ double epilogue(float hi, float lo, double rsc,
                                           double csc) {
  const double v = __dadd_rn(static_cast<double>(hi), static_cast<double>(lo));
  return __dmul_rn(__dmul_rn(v, rsc), csc);
}

// ------------------------------------------------------------------------
// Tensor-core route: the concatenated schedule (pairwise == 0).

constexpr int BM = 128;                  // CTA tile rows: 2 x 64
constexpr int BN = 128;                  // CTA tile columns: one n128 wgmma
constexpr int BK = 128;                  // k bytes per stage = swizzle span
constexpr int STAGES = 4;                // ring depth
constexpr int CLUSTER = 2;               // CTAs along N sharing the A tile
constexpr int CONSUMERS = 2;             // consumer warpgroups
constexpr int TC_THREADS = (CONSUMERS + 1) * 128;  // + producer
constexpr int TILE_A = BM * BK;          // 16 KB
constexpr int TILE_B = BN * BK;          // 16 KB
constexpr uint32_t STAGE_TX = TILE_A + TILE_B;
constexpr int TILE_LO = CONSUMERS * 128 * 64 * 4;   // the pairs' lo, 64 KB
constexpr int TC_SMEM =
    STAGES * (TILE_A + TILE_B) + TILE_LO + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Whether the phase of parity `parity` has completed (try_wait: the
// thread may sleep a while before it answers no).
__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// Spins until that phase has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_done(bar, parity)) {
  }
}
// The same for the producer, which traps after 2^28 polls: every
// legitimate wait here is microseconds, 2^28 polls are seconds. The
// producer's last waits are for the consumers' last releases, so a
// pipeline fault anywhere ends in a launch error the wrapper's caller sees
// at the next synchronisation, not in a hung card. (The consumers' waits
// keep no counter: its register would spill.)
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  for (uint32_t polls = 1; !mbar_done(bar, parity); ++polls)
    if (polls == (1u << 28)) __trap();
}

// Arrive on the barrier at the same offset in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The same box into the same shared offset of every CTA in `mask`,
// completing on each one's barrier at offset `bar`.
__device__ __forceinline__ void tma_load_3d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask)
      : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, rows of 128
// bytes in 8-row groups 1024 bytes apart (SBO); LBO unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulator across a wait.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D += A . B^T on a 64x128 tile, k = 32 bytes. Fragment: d[4j + 2h + b]
// is row 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + b.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D = A . B^T on a 64x128 tile, k = 32 bytes, starting a new sum: D is
// output only, so its registers are free from the last combine to here.
__device__ __forceinline__ void wgmma_m64n128k32_first(int (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
        "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]),
        "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31]),
        "=r"(d[32]), "=r"(d[33]), "=r"(d[34]), "=r"(d[35]),
        "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]),
        "=r"(d[40]), "=r"(d[41]), "=r"(d[42]), "=r"(d[43]),
        "=r"(d[44]), "=r"(d[45]), "=r"(d[46]), "=r"(d[47]),
        "=r"(d[48]), "=r"(d[49]), "=r"(d[50]), "=r"(d[51]),
        "=r"(d[52]), "=r"(d[53]), "=r"(d[54]), "=r"(d[55]),
        "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]),
        "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(TC_THREADS, 1)
digit_matmul_wgmma(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b,
                   const double* __restrict__ rs,
                   const double* __restrict__ cs, double* __restrict__ out,
                   int P, int M, int N, int K, int bits) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128B swizzle wants 1024-byte aligned tiles
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base;
  const uint32_t sB = sA + STAGES * TILE_A;
  const uint32_t sLo = sB + STAGES * TILE_B;
  const uint32_t full = sLo + TILE_LO;
  const uint32_t empty = full + STAGES * 8;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nkt = (K + BK - 1) / BK;     // >= 1: the launch refuses K = 0

  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      // one thread of every consumer warpgroup of the cluster: each
      // stage is written by every CTA's multicast
      mbar_init(empty + 8 * i, CLUSTER * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the peers' barriers exist before anything arrives on them
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");

  if (wg == CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_b))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < P; ++s)
        for (int p = 0; p <= s; ++p)
          for (int kt = 0; kt < nkt; ++kt) {
            mbar_wait_or_trap(empty + 8 * stage, phase ^ 1u);
            const uint32_t fb = full + 8 * stage;
            mbar_expect_tx(fb, STAGE_TX);
            // this CTA's 64 rows of the A tile go to both CTAs of the
            // cluster (they share m0); the B tile is its own
            tma_load_3d_multicast(sA + stage * TILE_A + rank * (TILE_A / 2),
                                  &tma_a, fb, kt * BK, m0 + rank * (BM / 2),
                                  p, 0x3);
            tma_load_3d(sB + stage * TILE_B, &tma_b, fb, kt * BK, n0, s - p);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1u;
            }
          }
      // the CTA stays until every consumer of the cluster has released
      // every stage: no arrival may reach it after it exits
      for (int i = 0; i < STAGES; ++i) {
        mbar_wait_or_trap(empty + 8 * stage, phase ^ 1u);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows 64*wg .. 64*wg+63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int warp = tid / 32;
  const int lane = tid % 32;
  // lo[i] of consumer thread t at word 256 i + t: conflict-free
  float* lo = reinterpret_cast<float*>(smem_raw + (sLo - smem_u32(smem_raw))) +
              threadIdx.x;
  int acc[64];
  float hi[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    hi[i] = 0.0f;
    lo[256 * i] = 0.0f;
  }
  const uint32_t a_rows = static_cast<uint32_t>(wg) * 64 * BK;
  int stage = 0;
  uint32_t phase = 0;
  int held = -1;       // stage whose wgmma group may still read shared memory
  // this warpgroup is done reading `stage`
  auto release = [&](int st) {
    if (tid == 0)
      for (uint32_t r = 0; r < CLUSTER; ++r)
        mbar_arrive_cluster(empty + 8 * st, r);
  };
  // One k-tile: four k32 steps. The first tile of a group starts the sum,
  // so the accumulator is dead from each combine to the next group.
  auto tile = [&](auto first) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t ta = sA + stage * TILE_A + a_rows;
    const uint32_t tb = sB + stage * TILE_B;
    wgmma_fence();
    if constexpr (decltype(first)::value)
      wgmma_m64n128k32_first(acc, sw128_desc(ta), sw128_desc(tb));
    else
      wgmma_m64n128k32(acc, sw128_desc(ta), sw128_desc(tb));
#pragma unroll
    for (int kk = 1; kk < BK / 32; ++kk)
      wgmma_m64n128k32(acc, sw128_desc(ta + 32 * kk),
                       sw128_desc(tb + 32 * kk));
    wgmma_commit();
    // one group stays in flight; the one before it is done reading
    wgmma_wait<1>();
    if (held >= 0) release(held);
    held = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  };
  for (int s = 0; s < P; ++s) {
    // the k-tiles of group s: A_p . B_{s-p} for p = 0..s, in the
    // producer's order
    tile(std::true_type{});
    for (int t = 1; t < (s + 1) * nkt; ++t) tile(std::false_type{});
    wgmma_wait<0>();
    fence_acc(acc);
    release(held);
    held = -1;
    const float sc = ldexpf(1.0f, -bits * (s + 2));
#pragma unroll
    for (int i = 0; i < 64; ++i) combine(hi[i], lo[256 * i], acc[i], sc);
  }

  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    const double rsc = rs[r];
    double* orow = out + static_cast<long long>(r) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j;
      const int i = 4 * j + 2 * h;
      if (c + 1 < N && (N & 1) == 0) {
        double2 v;
        v.x = epilogue(hi[i], lo[256 * i], rsc, cs[c]);
        v.y = epilogue(hi[i + 1], lo[256 * (i + 1)], rsc, cs[c + 1]);
        *reinterpret_cast<double2*>(orow + c) = v;
      } else {
        if (c < N) orow[c] = epilogue(hi[i], lo[256 * i], rsc, cs[c]);
        if (c + 1 < N)
          orow[c + 1] = epilogue(hi[i + 1], lo[256 * (i + 1)], rsc,
                                 cs[c + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------------
// __dp4a route: the pairwise schedule (pairwise == 1) only.

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int DK = 32;             // contraction bytes per shared-memory slab
constexpr int KW = DK / 4;         // packed int8x4 words per slab row
constexpr int LDS = KW + 1;        // padded shared row: spreads the banks
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each

// The 4 bytes at k = gk..gk+3 of a K-major row, those at k >= c1 zeroed.
// gk is a multiple of 4 below c1 <= Kp, so the word lies inside the row.
__device__ __forceinline__ int load_word(const int8_t* row, int gk, int c1) {
  if (gk >= c1) return 0;
  const int w = *reinterpret_cast<const int*>(row + gk);
  const int nb = c1 - gk;
  return nb >= 4 ? w : (w & ((1 << (8 * nb)) - 1));
}

__global__ void __launch_bounds__(THREADS)
digit_matmul_dp4a(const int8_t* __restrict__ ad, const int8_t* __restrict__ bd,
                  const double* __restrict__ rs,
                  const double* __restrict__ cs, double* __restrict__ out,
                  int P, int M, int N, int Kp, int K, int bits, int kchunk) {
  __shared__ int As[TM][LDS];      // As[row][k/4]: 4 k-values of one row
  __shared__ int Bs[TN][LDS];      // Bs[col][k/4]: 4 k-values of one column

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const long long mk = static_cast<long long>(M) * Kp;
  const long long nk = static_cast<long long>(N) * Kp;

  float hi[4][4], lo[4][4];
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hi[i][j] = 0.0f;
      lo[i][j] = 0.0f;
      acc[i][j] = 0;
    }

  for (int s = 0; s < P; ++s) {
    const float sc = ldexpf(1.0f, -bits * (s + 2));
    for (int p = 0; p <= s; ++p) {
      const int8_t* A = ad + p * mk;
      const int8_t* B = bd + (s - p) * nk;
      for (int ch0 = 0; ch0 < K; ch0 += kchunk) {
        const int ch1 = min(K, ch0 + kchunk);
        for (int k0 = ch0 - ch0 % 4; k0 < ch1; k0 += DK) {
          for (int w = tid; w < TM * KW; w += THREADS) {
            const int r = w / KW;
            const int gk = k0 + 4 * (w % KW);
            const int gr = row0 + r;
            int v = 0;
            if (gr < M) {
              v = load_word(A + gr * static_cast<long long>(Kp), gk, ch1);
              if (gk < ch0) v &= ~((1 << (8 * (ch0 - gk))) - 1);
            }
            As[r][w % KW] = v;
          }
          for (int w = tid; w < TN * KW; w += THREADS) {
            const int c = w / KW;
            const int gk = k0 + 4 * (w % KW);
            const int gc = col0 + c;
            int v = 0;
            if (gc < N) {
              v = load_word(B + gc * static_cast<long long>(Kp), gk, ch1);
              if (gk < ch0) v &= ~((1 << (8 * (ch0 - gk))) - 1);
            }
            Bs[c][w % KW] = v;
          }
          __syncthreads();
#pragma unroll
          for (int kw = 0; kw < KW; ++kw) {
            int a[4], bb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kw];
#pragma unroll
            for (int j = 0; j < 4; ++j) bb[j] = Bs[tx + 16 * j][kw];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = __dp4a(a[i], bb[j], acc[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            combine(hi[i][j], lo[i][j], acc[i][j], sc);
            acc[i][j] = 0;
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
    const double rsc = rs[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      out[static_cast<long long>(r) * N + c] =
          epilogue(hi[i][j], lo[i][j], rsc, cs[c]);
    }
  }
}

// ------------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// TMA map of a K-major digit stack [P, rows, Kp] read over its first K
// columns (K >= 1; rows Kp bytes apart): boxes of box_rows rows x 128
// bytes of one digit, 128B swizzle, zero fill past every edge.
CUresult stack_map(CUtensorMap* map, const void* ptr, int P, int rows, int K,
                   int Kp, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(P)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(Kp),
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[3] = {BK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A map is a function of its arguments alone, so maps are kept by them:
// a stack read again (the static operator digits, the allocator's reused
// buffers) costs a lookup instead of an encoding.
struct MapKey {
  uintptr_t ptr;
  int P, rows, K, Kp, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && P == o.P && rows == o.rows && K == o.K &&
           Kp == o.Kp && box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<uintptr_t>()(k.ptr);
    for (int v : {k.P, k.rows, k.K, k.Kp, k.box_rows})
      h = h * 1000003u ^ std::hash<int>()(v);
    return h;
  }
};

CUresult cached_map(CUtensorMap* map, const void* ptr, int P, int rows, int K,
                    int Kp, int box_rows) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{reinterpret_cast<uintptr_t>(ptr), P, rows, K, Kp,
                   box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return CUDA_SUCCESS;
  }
  const CUresult cr = stack_map(map, ptr, P, rows, K, Kp, box_rows);
  if (cr == CUDA_SUCCESS) {
    if (maps.size() >= 4096) maps.clear();
    maps.emplace(key, *map);
  }
  return cr;
}

// The kernel's dynamic shared memory exceeds the default 48 KB: allowed
// once per device.
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(digit_matmul_wgmma,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TC_SMEM);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer-sized integer).
// Returns 0 on success, a cudaError_t of the launch, or 1000 + the CUresult
// of a failed tensor-map encoding; never synchronises.
extern "C" int digit_matmul_launch(const void* ad, const void* bd,
                                   const void* rs, const void* cs, void* out,
                                   int P, int M, int N, int Kp, int K,
                                   int bits, int kchunk, int pairwise,
                                   void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (P < 1 || P > 7 || bits < 1 || bits > 7 || kchunk < 1 || Kp < 16 ||
      Kp % 16 != 0 || K < 0 || K > Kp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* dr = static_cast<const double*>(rs);
  const auto* dc = static_cast<const double*>(cs);
  auto* o = static_cast<double*>(out);
  if (pairwise) {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
    digit_matmul_dp4a<<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(ad), static_cast<const int8_t*>(bd), dr, dc,
        o, P, M, N, Kp, K, bits, kchunk);
    return static_cast<int>(cudaGetLastError());
  }
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  CUresult cr = cached_map(&ma, ad, P, M, K, Kp, BM / CLUSTER);
  if (cr == CUDA_SUCCESS) cr = cached_map(&mb, bd, P, N, K, Kp, BN);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  // whole clusters along N: a CTA past the last column loads zeros and
  // stores nothing, but still sends its share of A to its peer
  const int nct = (N + BN - 1) / BN;
  const dim3 grid((nct + CLUSTER - 1) / CLUSTER * CLUSTER,
                  (M + BM - 1) / BM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  digit_matmul_wgmma<<<grid, TC_THREADS, TC_SMEM, st>>>(ma, mb, dr, dc, o, P,
                                                        M, N, K, bits);
  return static_cast<int>(cudaGetLastError());
}
