// The warp-specialised attention forward on Hopper shared by K7 (the
// online softmax, `flash_attention_online.cu`) and K3/K6 (the static
// softmax bound, `flash_attention.cu`). Each source states its semantics,
// bound and design; this header holds the one kernel body. Its template
// parameter STATIC picks the softmax:
//   - online (K7): a running row max m; p = exp2(s log2 e - m log2 e);
//     O and l rescaled by exp2((m_prev - m) log2 e) every tile; tiles
//     wholly at or past n_valid skipped; lse = m + log l;
//   - static (K3/K6): s clipped to [-40, 40] after the key mask, p =
//     exp2(s log2 e - 40 log2 e) by one MUFU.EX2 (`exp2_ftz`: p >= e^-80
//     is a normal float, so flushing subnormals changes nothing), no max
//     and no rescale (tiles simply add); every tile up to N is walked,
//     because keys in [n_valid, N) still weigh e^-80; keys at or past N
//     (zero-filled by TMA in the last tile) get p = 0; lse = 40 + log l.
// and NC the consumer warpgroups: 2 for K7 (240 registers each), 3 for
// K3/K6 at D = 64 (160 each, FlashAttention-3's choice at D = 64, where
// S, O and P take 128 registers a thread).
//
// A block owns 64 NC query rows of one head; 128 (NC + 1) threads:
//   - warpgroup 0, the producer (24 registers, 32 at NC = 3): one thread
//     loads Q once, then 128-key tiles of K and V into two two-stage
//     rings (full/empty mbarriers for each), by TMA through 3-D (D, N, BH)
//     tensor maps with the 128-byte swizzle (a D = 128 row is two
//     64-column atoms). Rows past N load as zeros and never reach another
//     head;
//   - warpgroups 1..NC each own 64 query rows. Per key tile j a
//     warpgroup issues S_j = Q K_j^T by SS wgmma and O += P_{j-1} V_{j-1}
//     by RS wgmma (P from registers; V as stored is the MN-major B
//     operand), waits for both, frees K_j and V_{j-1} and runs the softmax
//     of S_j, whose accumulator becomes the bf16 A fragment of the next
//     P V in place (`hopper.cuh`'s fragment layout). The warpgroups take
//     turns issuing, in a ring of named barriers, so one's softmax runs
//     under the others' products. Tile 0's S and the last P V are peeled
//     out of the loop: with the first tile inside it, ptxas serialised
//     the wgmmas (C7514).
//   - Query rows at or past N are computed on zeros and not stored.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace s3od {
namespace flash_ws {
namespace {

typedef __nv_bfloat16 bf16;
using namespace s3od::hopper;

constexpr int BN = 128, STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float BOUND_HI = 40.f, BOUND_LO = -40.f;

// Elements of one 128-row x 64-column swizzle atom.
constexpr int ATOM = 128 * 64;

template <int D, int NC>
constexpr int smem_bytes() {
  // 1024 bytes of slack to align the tiles; Q (64 NC rows), the K and V
  // rings; 9 barriers.
  return 1024 + (D / 64) * (64 * NC + 2 * STAGES * 128) * 64 * 2 + 9 * 8;
}

template <int D, bool STATIC, int NC>
__global__ void __launch_bounds__(ws_threads(NC), 1)
    flash_ws_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                        float* __restrict__ lse, int n, int n_valid) {
  constexpr int ATOMS = D / 64;
  constexpr int BM = 64 * NC;           // query rows of a block
  constexpr int QATOM = BM * 64;        // elements of one Q atom
  constexpr int TILE = ATOMS * ATOM;    // elements of a 128-row K or V tile
  constexpr uint32_t TILE_BYTES = TILE * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = sQ + ATOMS * QATOM;   // [STAGES][ATOMS][128][64]
  bf16* sV = sK + STAGES * TILE;   // [STAGES][ATOMS][128][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  // Key tiles walked: the static bound weighs every key below N; the
  // online softmax gives keys at or past n_valid p = 0 exactly.
  const int nkt = ((STATIC ? n : n_valid) + BN - 1) / BN;

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
      mbar_expect_tx(q_full, ATOMS * QATOM * 2);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) tma_load_3d(sQ + a * QATOM, &map_q, q_full, a * 64, q0, bh);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt & 1, ph = (kt >> 1) & 1;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_expect_tx(&k_full[s], TILE_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          tma_load_3d(sK + s * TILE + a * ATOM, &map_k, &k_full[s], a * 64, kt * BN, bh);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], TILE_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          tma_load_3d(sV + s * TILE + a * ATOM, &map_v, &v_full[s], a * 64, kt * BN, bh);
      }
    }
  } else {
    setmaxnreg_inc<ws_consumer_regs(NC)>();
    const int half = wg - 1;
    const int t = threadIdx.x - 128 * wg, quad = t & 3;
    const int r0 = q0 + half * 64 + (t >> 5) * 16 + ((t & 31) >> 2), r1 = r0 + 8;
    const bf16* qh = sQ + half * 64 * 64;  // this warpgroup's rows of each atom

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float sacc[BN / 2];
    uint32_t p[BN / 16][4];
    // Running max (raw logits; online only) and this thread's share of
    // the denominator, rows r0 and r1.
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    // Static bound: the first tile that holds a key at or past n_valid.
    const int edge_tile = n_valid / BN;

    auto issue_s = [&](int kt) {  // S = Q K_kt^T
      const bf16* tk = sK + (kt & 1) * TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<BN>::mma(sacc, desc_sw128(qh + (kk / 4) * QATOM + (kk % 4) * 16),
                         desc_sw128(tk + (kk / 4) * ATOM + (kk % 4) * 16), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int kt) {  // O += P V_kt
      const bf16* tv = sV + (kt & 1) * TILE;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        WgmmaRS<D>::mma(oacc, p[kk], desc_sw128(tv + kk * 16 * 64, ATOM * 2), 1);
      wgmma_commit();
    };
    // The online softmax of tile kt on S: key mask (last tile only), the
    // row maxima (a row's 128 keys are spread over the 4 threads of a
    // quad), p = exp2(s log2 e - m log2 e) in place; returns the rescale
    // factors and the row sums of p through a0, a1, s0, s1.
    auto softmax_online = [&](int kt, float& a0, float& a1, float& s0, float& s1) {
      if (kt == nkt - 1) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kt * BN + 8 * j + 2 * quad + (e & 1) >= n_valid) sacc[4 * j + e] += NEG_INF;
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
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
      const float ms0 = mn0 * LOG2E, ms1 = mn1 * LOG2E;
      a0 = exp2f(fmaf(m0, LOG2E, -ms0));
      a1 = exp2f(fmaf(m1, LOG2E, -ms1));
      m0 = mn0;
      m1 = mn1;
      s0 = 0.f;
      s1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sacc[4 * j] = exp2f(fmaf(sacc[4 * j], LOG2E, -ms0));
        sacc[4 * j + 1] = exp2f(fmaf(sacc[4 * j + 1], LOG2E, -ms0));
        sacc[4 * j + 2] = exp2f(fmaf(sacc[4 * j + 2], LOG2E, -ms1));
        sacc[4 * j + 3] = exp2f(fmaf(sacc[4 * j + 3], LOG2E, -ms1));
        s0 += sacc[4 * j] + sacc[4 * j + 1];
        s1 += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
    };
    // The static-bound softmax of tile kt on S: keys at or past n_valid
    // get -1e30, s is clipped to [-40, 40], p = exp2(s log2 e - 40 log2 e)
    // in place; keys at or past N (zero rows of K) get p = 0. EDGE: the
    // tile holds a key at or past n_valid, so the masks are tested.
    auto softmax_static = [&](auto edge, int kt, float& s0, float& s1) {
      constexpr bool EDGE = decltype(edge)::value;
      s0 = 0.f;
      s1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt * BN + 8 * j + 2 * quad + (e & 1);
          float x = sacc[4 * j + e];
          if (EDGE && col >= n_valid) x += NEG_INF;
          x = fminf(fmaxf(x, BOUND_LO), BOUND_HI);
          float pe = exp2_ftz(fmaf(x, LOG2E, -BOUND_HI * LOG2E));
          if (EDGE && col >= n) pe = 0.f;
          sacc[4 * j + e] = pe;
          if (e < 2)
            s0 += pe;
          else
            s1 += pe;
        }
      }
    };
    // The softmax of tile kt, then: rescale O and l (online), add the row
    // sums to l, and P := bf16(p) as the A fragment of the next P V.
    auto softmax = [&](int kt) {
      float a0 = 1.f, a1 = 1.f, s0, s1;
      if constexpr (STATIC) {
        if (kt >= edge_tile)
          softmax_static(std::true_type(), kt, s0, s1);
        else
          softmax_static(std::false_type(), kt, s0, s1);
        l0 += s0;
        l1 += s1;
      } else {
        softmax_online(kt, a0, a1, s0, s1);
        l0 = l0 * a0 + s0;
        l1 = l1 * a1 + s1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          oacc[4 * j] *= a0;
          oacc[4 * j + 1] *= a0;
          oacc[4 * j + 2] *= a1;
          oacc[4 * j + 3] *= a1;
        }
      }
      pack_a(p, sacc);
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
    softmax(0);
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
      softmax(kt);
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
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* ob = o + (size_t)bh * n * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
            pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
            pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
    if (quad == 0) {
      const float c0 = STATIC ? BOUND_HI : m0, c1 = STATIC ? BOUND_HI : m1;
      float* lb = lse + (size_t)bh * n;
      if (r0 < n) lb[r0] = c0 + logf(l0);
      if (r1 < n) lb[r1] = c1 + logf(l1);
    }
  }
}

// Encodes the three tensor maps and launches the kernel on (bh, n, D)
// bf16 q, k, v (16-byte aligned), o and fp32 (bh, n) lse. Returns 0 or a
// CUDA error code.
template <int D, bool STATIC, int NC>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
               int n_valid, cudaStream_t st) {
  constexpr int BM = 64 * NC;
  CUtensorMap maps[3];
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)n * D * 2};
  const uint32_t box_q[3] = {64, BM, 1}, box_kv[3] = {64, 128, 1};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_bf16_map(&maps[i], ptrs[i], 3, dims, strides, i ? box_kv : box_q);
    if (err) return err;
  }
  constexpr int smem = smem_bytes<D, NC>();
  cudaError_t err = cudaFuncSetAttribute(flash_ws_fwd_kernel<D, STATIC, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BM - 1) / BM, bh);
  flash_ws_fwd_kernel<D, STATIC, NC><<<grid, ws_threads(NC), smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), static_cast<float*>(lse), n, n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace flash_ws
}  // namespace s3od
