// K7: attention forward with the exact row-max (online) softmax.
//
// Replaces `_fwd_kernel` of `s3od_tpu/ops/flash_attention.py` (the
// streaming online-softmax forward, dispatched by `_flash_forward` and the
// public `flash_attention` without the static bound), and the row-max mode
// of `_fwd_kernel_single` (`static_bound=False`): both compute the same
// exact softmax, and which one the TPU runs is a VMEM rule (`_pick_blocks`)
// that is not ported. The MMDiT reaches it at every attention: 4608 tokens
// at 1024^2 (24 heads of D = 128), 4098 -> 4160 on the concept stream.
//
// Semantics, kept to the letter:
//   - the softmax scale is already folded into q (in bf16) by the caller,
//     so s = q @ k^T;
//   - keys at or past n_valid get the bias -1e30;
//   - m starts at -1e30; m_new = max(m_prev, max_j s_j);
//   - p = exp(s - m_new) is rounded to bf16 for P V, while l sums the fp32 p;
//   - acc and l are rescaled by alpha = exp(m_prev - m_new);
//   - o = acc / l, lse = m + log l (fp32, for a later backward).
// Both exponentials are taken in base 2 with log2(e) folded in:
// p = exp2(fma(s, log2 e, -m log2 e)), a few fp32 ulps from exp(s - m),
// far below the one bf16 rounding of p.
//
// Bound on the H100: 4 * BH * N^2 * D operations (two products), at
// (24, 4608, 128) 2.61e11, 0.264 ms at 989 TFLOP/s, against ~0.11 GB of
// q, k, v, o (0.03 ms at 3.35 TB/s): compute-bound on the tensor cores,
// with one exponential per logit on the SFU as the second limit.
//
// Design (FlashAttention-3's shape, arXiv 2407.08608): a block owns 128
// query rows of one head; 384 threads.
//   - Warpgroup 0 is the producer (24 registers after `setmaxnreg`): one
//     thread loads Q once and then 128-key tiles of K and V into two
//     two-stage rings (separate full/empty mbarriers for K and V), by TMA
//     through 3-D tensor maps (D, N, BH) with the 128-byte swizzle (a
//     D = 128 row is two 64-column atoms). Rows past N — N = 4160 is an
//     odd multiple of 64 — load as zeros and never reach another head.
//   - Warpgroups 1 and 2 (240 registers) each own 64 query rows. Per key
//     tile j a warpgroup issues, in one turn, S_j = Q K_j^T by SS wgmma
//     (K as stored is the K-major B operand) and O += P_{j-1} V_{j-1} by
//     RS wgmma (P from registers; V as stored is the MN-major B operand,
//     wgmma's transpose bit), waits for both, frees K_j and V_{j-1}, and
//     runs the softmax of S_j. The S accumulator becomes the bf16 A
//     fragment of P V in place (`hopper.cuh`'s fragment layout).
//   - Ping-pong: the two warpgroups take turns issuing (named barriers),
//     so one's softmax runs while the other's products occupy the tensor
//     cores. Timed on the H100 against the same kernel without turns, it
//     was faster at D = 64 and no slower at D = 128. Waiting for S_j alone
//     (wait_group 1) and running the softmax under P_{j-1} V_{j-1} measured
//     no faster; with the first key tile inside the loop, ptxas serialised
//     those wgmmas (C7514) and the kernel ran markedly slower.
//   - Tiles wholly at or past n_valid are skipped: there p = exp(-1e30 -
//     m) = 0 and alpha = 1 exactly, so the result is the full loop's. The
//     key mask runs on the last tile only. Query rows at or past N are
//     computed on zeros and not stored.
#include "hopper.cuh"

using namespace s3od;
using namespace s3od::hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, THREADS = 384, STAGES = 2;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Elements of one 128-row x 64-column swizzle atom.
constexpr int ATOM = 128 * 64;

template <int D>
constexpr int smem_bytes() {
  // 1024 bytes of slack to align the tiles; Q, the K and V rings; 9
  // barriers.
  return 1024 + (1 + 2 * STAGES) * (D / 64) * ATOM * 2 + 9 * 8;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_online_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                            float* __restrict__ lse, int n, int n_valid) {
  constexpr int ATOMS = D / 64;
  constexpr int TILE = ATOMS * ATOM;  // elements of a 128-row Q, K or V tile
  constexpr uint32_t TILE_BYTES = TILE * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = sQ + TILE;            // [STAGES][ATOMS][128][64]
  bf16* sV = sK + STAGES * TILE;   // [STAGES][ATOMS][128][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int nkt = (n_valid + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2 * 128);
      mbar_init(&v_empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, TILE_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) tma_load_3d(sQ + a * ATOM, &map_q, q_full, a * 64, q0, bh);
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
    setmaxnreg_inc<CONSUMER_REGS>();
    const int half = wg - 1;
    const int t = threadIdx.x - 128 * wg, quad = t & 3;
    const int r0 = q0 + half * 64 + (t >> 5) * 16 + ((t & 31) >> 2), r1 = r0 + 8;
    const bf16* qh = sQ + half * 64 * 64;  // this warpgroup's rows of each atom

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float sacc[BN / 2];
    uint32_t p[BN / 16][4];
    // Running max (raw logits) and this thread's share of the
    // denominator, rows r0 and r1.
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    auto issue_s = [&](int kt) {  // S = Q K_kt^T
      const bf16* tk = sK + (kt & 1) * TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<BN>::mma(sacc, desc_sw128(qh + (kk / 4) * ATOM + (kk % 4) * 16),
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
    // The softmax of tile kt on S: key mask (last tile only), the row
    // maxima (a row's 128 keys are spread over the 4 threads of a quad),
    // p = exp2(s log2 e - m log2 e) in place; returns the rescale factors
    // and the row sums of p through a0, a1, s0, s1.
    auto softmax = [&](int kt, float& a0, float& a1, float& s0, float& s1) {
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
    // Rescale O and l, and P := bf16(p) as the A fragment of the next P V.
    auto update = [&](float a0, float a1, float s0, float s1) {
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= a0;
        oacc[4 * j + 1] *= a0;
        oacc[4 * j + 2] *= a1;
        oacc[4 * j + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        p[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    // The two consumer warpgroups take turns issuing their products
    // (named barriers 1 and 2: warpgroup h waits on 1 + h and, once its
    // products are issued, releases the other's), so one's softmax runs
    // under the other's products. Each takes nkt + 1 turns; warpgroup 1
    // opens the first and does not release after its last.
    auto turn_begin = [&]() { named_sync(1 + half, 256); };
    auto turn_end = [&](bool last) {
      if (!(last && half == 1)) named_arrive(2 - half, 256);
    };

    float a0, a1, s0, s1;
    mbar_wait(q_full, 0);
    if (half == 1) named_arrive(1, 256);  // warpgroup 0 goes first
    // Tile 0: S only.
    mbar_wait(&k_full[0], 0);
    turn_begin();
    wgmma_fence();
    issue_s(0);
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(sacc);
    mbar_arrive(&k_empty[0]);
    softmax(0, a0, a1, s0, s1);
    update(a0, a1, s0, s1);
    // Tiles 1..: S_kt with P_{kt-1} V_{kt-1}.
    for (int kt = 1; kt < nkt; ++kt) {
      const int s = kt & 1;
      mbar_wait(&k_full[s], (kt >> 1) & 1);
      mbar_wait(&v_full[s ^ 1], ((kt - 1) >> 1) & 1);
      turn_begin();
      fence_regs(oacc);
      fence_regs(p);
      wgmma_fence();
      issue_s(kt);
      issue_pv(kt - 1);
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(oacc);
      fence_regs(p);  // P_{kt-1} stays in its registers until its product is done
      mbar_arrive(&k_empty[s]);
      mbar_arrive(&v_empty[s ^ 1]);
      softmax(kt, a0, a1, s0, s1);
      update(a0, a1, s0, s1);
    }
    // The last tile's P V.
    mbar_wait(&v_full[(nkt - 1) & 1], ((nkt - 1) >> 1) & 1);
    turn_begin();
    fence_regs(oacc);
    fence_regs(p);
    wgmma_fence();
    issue_pv(nkt - 1);
    turn_end(true);
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
      float* lb = lse + (size_t)bh * n;
      if (r0 < n) lb[r0] = m0 + logf(l0);
      if (r1 < n) lb[r1] = m1 + logf(l1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
           int n_valid, cudaStream_t st) {
  CUtensorMap maps[3];
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)n * D * 2};
  const uint32_t box[3] = {64, 128, 1};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_bf16_map(&maps[i], ptrs[i], 3, dims, strides, box);
    if (err) return err;
  }
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_online_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BM - 1) / BM, bh);
  flash_online_fwd_kernel<D><<<grid, THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), static_cast<float*>(lse), n, n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, n, d) bf16, 16-byte aligned; lse: (bh, n) fp32. n a
// multiple of 64, d in {64, 128}, 0 < n_valid <= n (checked by the Python
// wrapper).
extern "C" int s3od_flash_attention_online_fwd(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int bh, int n, int d,
                                               int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_valid <= 0 || n_valid > n) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 128) return launch<128>(q, k, v, o, lse, bh, n, n_valid, st);
  if (d == 64) return launch<64>(q, k, v, o, lse, bh, n, n_valid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
