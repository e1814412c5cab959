// E1, E3a and E4: the flash-softmax experiments' attention forward, one
// template for all of their variants.
//
// Replaces three TPU kernels of the experiments in `benchmarks/`:
//   E1 `exp_flash_softmax.py` `make_kernel` (online softmax on a
//      (bh, nq, nk) grid; variants base / exp2 / exp2_bf16, no lse);
//   E3a `exp_exp2.py` `_exp2_flash` (`_exp2_single_kernel` and
//      `_exp2_stream_kernel`: the static +-40 bound in base 2, with lse);
//   E4 `exp_flash_single.py` `make_run` (one K block with lse; variants
//      base / nomax_inscale / nomax_clip2 / min_eps / nomax).
// What varies between them is the softmax, not the products, so one kernel
// covers them, switched by the template arguments:
//   ONLINE    row max: running m per row, tiles rescaled by
//             alpha = exp(m_prev - m_new) (E1, E4 base); else the static
//             bound: p = exp(clip(s, lo, hi) - hi), m = hi fixed, no
//             rescale (lo = -inf gives the one-sided min(s, hi) - hi);
//   BASE2     exp2 instead of exp (the caller folds log2 e into `mult`);
//   BF16_ARG  p = exp2(bf16(s - m)) on the packed `ex2.approx.ftz.bf16x2`
//             unit, Hopper's counterpart of the TPU's packed bf16 VPU ops:
//             p itself is bf16 and l sums those bf16 values. It may differ
//             from exp2-then-round by one bf16 step.
// and by runtime arguments: the logits are s = (q k^T) * mult + bias (bias
// fp32 per key, or none), l gets l_eps added before o = acc / l, lse is
// written where its pointer is not null (lse = m + log l, m * ln 2 in base
// 2), and `extra_keys` zero keys with bias -1e30 are appended after the n
// real ones. That last one is E3a's padding, which is part of its function:
// the TPU kernel pads the keys to its block multiple and masks them, and a
// masked key still weighs exp(lo - hi) after the clip (e^-80). Here such
// keys are never loaded: their weight goes into l once per row.
//
// Each variant keeps its own exponential: the accurate `expf` (base e) or
// `exp2f` (base 2; no fast math), and the packed bf16 ex2 for BF16_ARG —
// the forms the experiments compare. One exception, exact: under a static
// bound in base 2 with lo - hi >= -126 (E3a: -80 log2 e), every argument
// of exp2 gives a normal float, where exp2f is one MUFU.EX2 behind a range
// check; that instance calls `hopper.cuh`'s exp2_ftz, the same MUFU.EX2
// without the check (K3/K6's exponential).
//
// The sequence length need not be a multiple of the tile (4104 = 32 * 128
// + 8 at the experiments' default): 3-D (D, N, BH) tensor maps load query
// and key rows past n as zeros without reaching the next head; query rows
// past n are computed on those zeros and not stored, keys past n get p = 0
// exactly, in the last tile only (the others skip every check). They are
// NOT given the -1e30 bias, which under a static bound would still weigh
// e^-60 or e^-80.
//
// The row max of E1 (block_k = n) and E4 base is taken over all keys before
// the exp on the TPU. Here it is one pass with the online rescale (as K7):
// it differs from the two-pass form only in where p is rounded to bf16 for
// P V (and, for exp2_bf16, where s - m is rounded), inside one bf16 step.
//
// Design: the warp-specialised body of K3/K6/K7 (`flash_fwd_ws.cuh`) at
// D = 64, copied here with the variants' softmax, so that K3/K6/K7's
// instantiations stay as they are. A block owns 192 query rows of one
// head, 512 threads:
//   - warpgroup 0, the producer (32 registers): one thread loads Q once,
//     then 128-key tiles of K and V into two two-stage rings by TMA, with
//     the 128-byte swizzle;
//   - warpgroups 1..3 (160 registers each) own 64 query rows each: per key
//     tile j, S_j = Q K_j^T by SS wgmma and O += P_{j-1} V_{j-1} by RS
//     wgmma (P from registers, V as stored is the MN-major B operand),
//     then the softmax of S_j, whose accumulator becomes the bf16 A
//     fragment of the next P V. The warpgroups take turns issuing, in a
//     ring of named barriers, so one's softmax runs under the others'
//     products. A bias is read per tile from L2 (8-byte pairs of keys);
//     without one (E1) nothing is added. (Loading it while the tile's
//     products run held 32 more registers and spilled: ptxas fits the
//     kernel in 128, the 512 threads' share of the register file.)
//
// Bound on the H100 at the experiments' default (96, 4104, 64): 4 BH N^2 D
// = 4.14e11 tensor-core FLOP, 0.419 ms at 989 TFLOP/s, and BH N^2 = 1.6e9
// exponentials, 0.415 ms at the SFUs' ~3.9e12/s: co-bound by the products
// and the exponentials; the 0.2 GB of q, k, v, o take 0.06 ms.
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

using namespace s3od;
using namespace s3od::hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64, BN = 128, STAGES = 2, NC = 3, BM = 64 * NC;
constexpr int TILE = BN * D;     // elements of a K or V tile (one swizzle atom wide)
constexpr int QTILE = BM * D;    // elements of the Q tile
constexpr int SMEM = 1024 + (QTILE + 2 * STAGES * TILE) * 2 + 9 * 8;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// exp or exp2; FTZ: exp2 by one MUFU.EX2 (`exp2_ftz`), which equals exp2f
// wherever 2^x is a normal float, x >= -126.
template <bool BASE2, bool FTZ = false>
__device__ __forceinline__ float ex(float x) {
  return BASE2 ? (FTZ ? exp2_ftz(x) : exp2f(x)) : expf(x);
}

// 2^x of two values rounded to bf16, on the packed bf16x2 unit: the packed
// bf16 result (lo value in the low half).
__device__ __forceinline__ uint32_t ex2_bf16x2(float lo, float hi) {
  const uint32_t a = pack_bf16(lo, hi);
  uint32_t d;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

struct Args {
  const float* bias;  // (n,) or null
  bf16* o;            // (bh, n, 64)
  float* lse;         // (bh, n) or null
  int n;
  float mult, lo, hi, l_eps;
  int extra_keys;
};

template <bool ONLINE, bool BASE2, bool BF16_ARG, bool FTZ>
__global__ void __launch_bounds__(ws_threads(NC), 1)
    exp_flash_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = sQ + QTILE;           // [STAGES][128][64]
  bf16* sV = sK + STAGES * TILE;   // [STAGES][128][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int n = a.n;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int nkt = (n + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], NC * 128);
      mbar_init(&v_empty[s], NC * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<ws_producer_regs(NC)>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, QTILE * 2);
      tma_load_3d(sQ, &map_q, q_full, 0, q0, bh);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt & 1, ph = (kt >> 1) & 1;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_expect_tx(&k_full[s], TILE * 2);
        tma_load_3d(sK + s * TILE, &map_k, &k_full[s], 0, kt * BN, bh);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], TILE * 2);
        tma_load_3d(sV + s * TILE, &map_v, &v_full[s], 0, kt * BN, bh);
      }
    }
    return;
  }
  setmaxnreg_inc<ws_consumer_regs(NC)>();
  const int half = wg - 1;
  const int t = threadIdx.x - 128 * wg, quad = t & 3;
  const int r0 = q0 + half * 64 + (t >> 5) * 16 + ((t & 31) >> 2), r1 = r0 + 8;
  const bf16* qh = sQ + half * 64 * 64;  // this warpgroup's rows

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float sacc[BN / 2];
  uint32_t p[BN / 16][4];
  // Row max (or the static shift hi) and this thread's share of the
  // denominator, rows r0 and r1.
  float m0 = ONLINE ? NEG_INF : a.hi, m1 = m0, l0 = 0.f, l1 = 0.f;
  // The exponent's argument: s - m, or clip(s, lo, hi) - hi.
  auto arg = [&](float x, float m) {
    return ONLINE ? x - m : fminf(fmaxf(x, a.lo), a.hi) - a.hi;
  };

  auto issue_s = [&](int kt) {  // S = Q K_kt^T
    const bf16* tk = sK + (kt & 1) * TILE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      WgmmaSS<BN>::mma(sacc, desc_sw128(qh + kk * 16), desc_sw128(tk + kk * 16), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int kt) {  // O += P V_kt
    const bf16* tv = sV + (kt & 1) * TILE;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgmmaRS<D>::mma(oacc, p[kk], desc_sw128(tv + kk * 16 * 64, TILE * 2), 1);
    wgmma_commit();
  };
  // The softmax of tile kt on S, then P := bf16(p) as the A fragment of
  // the next P V. EDGE: the last tile, which may hold keys at or past n.
  auto softmax = [&](auto edge, auto has_bias, int kt) {
    constexpr bool EDGE = decltype(edge)::value, BIAS = decltype(has_bias)::value;
    // Logits s * mult + bias; keys at or past n: -inf (online: p = 0 under
    // the row max) and no bias.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = kt * BN + 8 * j + 2 * quad;
      float2 bb = make_float2(0.f, 0.f);
      if (BIAS) {
        if (!EDGE) {
          bb = __ldg(reinterpret_cast<const float2*>(a.bias + col));
        } else {
          if (col < n) bb.x = __ldg(a.bias + col);
          if (col + 1 < n) bb.y = __ldg(a.bias + col + 1);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e] * a.mult;
        if (BIAS) x += (e & 1) ? bb.y : bb.x;
        if (ONLINE && EDGE && col + (e & 1) >= n) x = -INFINITY;
        sacc[4 * j + e] = x;
      }
    }
    float a0 = 1.f, a1 = 1.f;
    if (ONLINE) {  // a row's 128 keys are spread over the 4 threads of a quad
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = ex<BASE2, FTZ>(m0 - mn0);
      a1 = ex<BASE2, FTZ>(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (BF16_ARG) {
        const uint32_t p01 = ex2_bf16x2(arg(sacc[4 * j], m0), arg(sacc[4 * j + 1], m0));
        const uint32_t p23 = ex2_bf16x2(arg(sacc[4 * j + 2], m1), arg(sacc[4 * j + 3], m1));
        sacc[4 * j] = bf16_lo(p01);
        sacc[4 * j + 1] = bf16_hi(p01);
        sacc[4 * j + 2] = bf16_lo(p23);
        sacc[4 * j + 3] = bf16_hi(p23);
      } else {
        sacc[4 * j] = ex<BASE2, FTZ>(arg(sacc[4 * j], m0));
        sacc[4 * j + 1] = ex<BASE2, FTZ>(arg(sacc[4 * j + 1], m0));
        sacc[4 * j + 2] = ex<BASE2, FTZ>(arg(sacc[4 * j + 2], m1));
        sacc[4 * j + 3] = ex<BASE2, FTZ>(arg(sacc[4 * j + 3], m1));
      }
      if (!ONLINE && EDGE) {  // the clip lifted keys past n to lo
        const int col = kt * BN + 8 * j + 2 * quad;
        if (col >= n) sacc[4 * j] = sacc[4 * j + 2] = 0.f;
        if (col + 1 >= n) sacc[4 * j + 1] = sacc[4 * j + 3] = 0.f;
      }
      s0 += sacc[4 * j] + sacc[4 * j + 1];
      s1 += sacc[4 * j + 2] + sacc[4 * j + 3];
    }
    if (ONLINE) {
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= a0;
        oacc[4 * j + 1] *= a0;
        oacc[4 * j + 2] *= a1;
        oacc[4 * j + 3] *= a1;
      }
    } else {
      l0 += s0;
      l1 += s1;
    }
    pack_a(p, sacc);
  };
  auto softmax_tile = [&](int kt) {
    const bool edge = kt == nkt - 1;
    if (a.bias == nullptr) {
      if (edge)
        softmax(std::true_type(), std::false_type(), kt);
      else
        softmax(std::false_type(), std::false_type(), kt);
    } else {
      if (edge)
        softmax(std::true_type(), std::true_type(), kt);
      else
        softmax(std::false_type(), std::true_type(), kt);
    }
  };

  mbar_wait(q_full, 0);
  turns_open<NC>(half);
  // Tile 0: S only.
  mbar_wait(&k_full[0], 0);
  turn_begin(half);
  wgmma_fence();
  issue_s(0);
  turn_end<NC>(half, false);
  wgmma_wait<0>();
  fence_regs(sacc);
  mbar_arrive(&k_empty[0]);
  softmax_tile(0);
  // Tiles 1..: S_kt with P_{kt-1} V_{kt-1}.
  for (int kt = 1; kt < nkt; ++kt) {
    const int s = kt & 1;
    mbar_wait(&k_full[s], (kt >> 1) & 1);
    mbar_wait(&v_full[s ^ 1], ((kt - 1) >> 1) & 1);
    turn_begin(half);
    fence_regs(oacc);
    fence_regs(p);
    wgmma_fence();
    issue_s(kt);
    issue_pv(kt - 1);
    turn_end<NC>(half, false);
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(oacc);
    fence_regs(p);  // P_{kt-1} stays in its registers until its product is done
    mbar_arrive(&k_empty[s]);
    mbar_arrive(&v_empty[s ^ 1]);
    softmax_tile(kt);
  }
  // The last tile's P V.
  mbar_wait(&v_full[(nkt - 1) & 1], ((nkt - 1) >> 1) & 1);
  turn_begin(half);
  fence_regs(oacc);
  fence_regs(p);
  wgmma_fence();
  issue_pv(nkt - 1);
  turn_end<NC>(half, true);
  wgmma_wait<0>();
  fence_regs(oacc);

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  if (a.extra_keys > 0) {  // zero keys with bias -1e30: s = -1e30
    const float pa = arg(NEG_INF, m0), pb = arg(NEG_INF, m1);
    const float pe0 = BF16_ARG ? bf16_lo(ex2_bf16x2(pa, pa)) : ex<BASE2, FTZ>(pa);
    const float pe1 = BF16_ARG ? bf16_lo(ex2_bf16x2(pb, pb)) : ex<BASE2, FTZ>(pb);
    l0 += a.extra_keys * pe0;
    l1 += a.extra_keys * pe1;
  }
  l0 += a.l_eps;
  l1 += a.l_eps;
  bf16* ob = a.o + (size_t)bh * n * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
          pack_bf16(oacc[4 * j] / l0, oacc[4 * j + 1] / l0);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
          pack_bf16(oacc[4 * j + 2] / l1, oacc[4 * j + 3] / l1);
  }
  if (a.lse != nullptr && quad == 0) {
    float* lb = a.lse + (size_t)bh * n;
    const float c = BASE2 ? LN2 : 1.f;
    if (r0 < n) lb[r0] = m0 * c + logf(l0);
    if (r1 < n) lb[r1] = m1 * c + logf(l1);
  }
}

template <bool ONLINE, bool BASE2, bool BF16_ARG, bool FTZ = false>
int launch(const void* q, const void* k, const void* v, const Args& a, int bh,
           cudaStream_t st) {
  CUtensorMap maps[3];
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)a.n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)a.n * D * 2};
  const uint32_t box_q[3] = {64, BM, 1}, box_kv[3] = {64, BN, 1};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_bf16_map(&maps[i], ptrs[i], 3, dims, strides, i ? box_kv : box_q);
    if (err) return err;
  }
  auto kernel = exp_flash_kernel<ONLINE, BASE2, BF16_ARG, FTZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.n + BM - 1) / BM, bh);
  kernel<<<grid, ws_threads(NC), SMEM, st>>>(maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, n, 64) bf16, 16-byte aligned; bias: (n,) fp32 (8-byte
// aligned) or null; lse: (bh, n) fp32 or null. variant = static (1) |
// base2 (2) | bf16_arg (4); the five used combinations are instantiated
// (checked by the Python wrapper).
extern "C" int s3od_exp_flash_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* o, void* lse, int bh, int n,
                                  int variant, float mult, float lo, float hi, float l_eps,
                                  int extra_keys, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(bias) % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(bias), static_cast<bf16*>(o), static_cast<float*>(lse),
               n, mult, lo, hi, l_eps, extra_keys};
  switch (variant) {
    case 0:
      return launch<true, false, false>(q, k, v, a, bh, st);
    case 2:
      return launch<true, true, false>(q, k, v, a, bh, st);
    case 6:
      return launch<true, true, true>(q, k, v, a, bh, st);
    case 1:
      return launch<false, false, false>(q, k, v, a, bh, st);
    case 3:  // every argument of exp2 lies in [lo - hi, 0]
      if (lo - hi >= -126.f) return launch<false, true, false, true>(q, k, v, a, bh, st);
      return launch<false, true, false>(q, k, v, a, bh, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
