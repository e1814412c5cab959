// K4: attention epilogue — o_proj over the heads + bias, x layerscale,
// + residual, then LayerNorm(norm2) of the bf16-rounded new stream.
//
// Replaces the TPU kernel `s3od_tpu/ops/attn_epilogue.py:_kernel` (via
// `attn_epilogue`). Inputs: the attention output a in its head-major
// layout (B*H, N, D), the o_proj weight Wo (C, C) in nn.Linear layout
// [c_out][h*D + d], the residual x (B, N, C) and the bf16 vectors bo, ls1,
// norm2 weight / bias. Outputs, both (B, N, C) bf16:
//   x' = bf16(x + (sum_h a_h @ Wo_h^T + bo) * ls1)   (fp32 until the round)
//   h  = LayerNorm(x') with fp32 statistics of the ROUNDED x',
//        var = max(E[x'^2] - E[x']^2, 0).
//
// Bound on the H100: at ViT-B, 1024^2 b1 the product is 2 x 4160 x 768^2 =
// 4.9 GFLOP (0.0050 ms at 989 TFLOP/s) over 26.7 MB of a, Wo, x, x' and h
// (0.0080 ms at 3.35 TB/s): bound by the bytes, by a small margin, at every
// batch (b16: 0.122 ms of bytes, 0.079 of products).
//
// D = 64 (ViT-S/B/L): a warp-specialised TMA + wgmma GEMM whose epilogue
// holds whole LayerNorm rows across a 2-block cluster
// (`attn_epilogue_wgmma`):
//   - a tile is 64 rows (tokens of one batch element: N is a multiple of
//     64) x all C; the two blocks of a cluster each own C / 2 columns (384
//     at ViT-B, 512 at ViT-L, 192 at ViT-S), split over NC consumer
//     warpgroups of WN <= 256 columns (SS wgmma m64nWNk16), so b1 fills
//     130 of 132 SMs where a whole-row block would fill 65;
//   - the K loop is over heads: one producer thread loads a head's 64 x
//     64 K-major A tile by TMA straight from the head-major layout through
//     a (D, N, B H) map, and Wo's (C / 2) x 64 slice in 128-byte-swizzled
//     boxes, into a ring of 2-4 stages on full/empty mbarriers;
//   - the block's x tile arrives by TMA on its own barrier while the
//     products run; the epilogue rounds x' in registers, writes it over x
//     in shared memory (the 128-byte swizzle: every bank once) and stores
//     it by TMA; each row's fp32 (sum x', sum x'^2) partials go through a
//     quad shuffle and shared memory, and each block reads its partner's
//     by `ld.shared::cluster` after the partner's remote mbarrier arrival,
//     both blocks summing in one order so the two halves of a row see the
//     same mean and rstd; h is staged over x' once the x' store has read
//     it, and stored by TMA;
//   - persistent over row tiles (b16: 1040 tiles): the next tile's x is
//     loaded once this tile's h store has read the staging slot, and the
//     ring runs ahead through the epilogue.
// Measured against it on the H100 and not kept (PERF.md section 6): the
// pair multicasting each A tile to both blocks, and a 2 x 2 cluster that
// also multicasts each Wo slice to two row tiles, halving Wo's L2 reads a
// row (18.4 KB -> 9.2 KB at ViT-B; the mma.sync kernel read 37.5 KB).
// Both were slower: a multicast stage is freed only when every block it
// feeds has released it, so the blocks run in lockstep, and at most 30
// clusters of 4 are resident. A block holding whole ViT-B rows (3
// consumer warpgroups of 256 columns) does not build: at 512 threads
// ptxas caps a thread at 128 registers and the m64n256 product needs 154
// (C7602).
// What holds it back (PERF.md section 6): its main loop runs at
// about half of the tensor cores' rate with 3 stages of 56 KB, and its
// epilogue takes a third of a tile, not overlapped with the products.
// D = 32 (the tiny checkpoints) keeps the mma.sync kernel
// (`attn_epilogue_mma_kernel`): 32 rows x all C a block, cp.async two
// stages deep; the entry point dispatches on D.
#include "hopper.cuh"  // and mma.cuh

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// D = 32: the mma.sync kernel
// ---------------------------------------------------------------------------

constexpr int S_BM = 32, S_BK = 32, S_LDK = S_BK + 8, S_THREADS = 512, S_MAXNT = 16;

__host__ __device__ constexpr int s_b_rows(int c) { return c + 16; }

size_t s_smem_bytes(int c) {
  return sizeof(bf16) * (2 * S_BM * S_LDK + 2 * (size_t)s_b_rows(c) * S_LDK);
}

__global__ void __launch_bounds__(S_THREADS)
    attn_epilogue_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wo,
                             const bf16* __restrict__ bo, const bf16* __restrict__ x,
                             const bf16* __restrict__ ls, const bf16* __restrict__ lw,
                             const bf16* __restrict__ lb, bf16* __restrict__ xn,
                             bf16* __restrict__ hout, int n, int c, int heads, int d,
                             float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [2][S_BM][S_LDK]
  bf16* sB = sA + 2 * S_BM * S_LDK;           // [2][s_b_rows(c)][S_LDK]
  float* sX = reinterpret_cast<float*>(sB);   // [S_BM][c + 8], after the loop
  const int ldx = c + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int row0 = blockIdx.x * S_BM;
  const int ncols = c / 8;   // columns owned by one warp
  const int nt = ncols / 8;  // its n8 tiles, 1..S_MAXNT
  const int colw = wn * ncols;
  const int bstage = s_b_rows(c) * S_LDK;

  auto load_stage = [&](int stage, int k0) {
    const int h = k0 / d, d0 = k0 - h * d;
    for (int i = tid; i < S_BM * (S_BK / 8); i += S_THREADS) {
      const int r = i >> 2, cc = (i & 3) * 8;
      const int row = row0 + r;
      const int bb = row / n, tok = row - bb * n;
      cp_async16(sA + (stage * S_BM + r) * S_LDK + cc,
                 a + (((size_t)bb * heads + h) * n + tok) * d + d0 + cc);
    }
    for (int i = tid; i < c * (S_BK / 8); i += S_THREADS) {
      const int r = i >> 2, cc = (i & 3) * 8;
      cp_async16(sB + stage * bstage + r * S_LDK + cc, wo + (size_t)r * c + k0 + cc);
    }
    cp_async_commit();
  };

  float acc[S_MAXNT][4];
#pragma unroll
  for (int i = 0; i < S_MAXNT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = c / S_BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * S_BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sa = sA + (kt & 1) * S_BM * S_LDK;
    const bf16* sb = sB + (kt & 1) * bstage;
#pragma unroll
    for (int ks = 0; ks < S_BK / 16; ++ks) {
      uint32_t af[4];
      load_a_frag(af, sa + wm * 16 * S_LDK + ks * 16, S_LDK, lane);
#pragma unroll
      for (int np = 0; np < S_MAXNT / 2; ++np) {
        if (2 * np < nt) {
          // An odd tile count reads 8 rows past the warp's columns (at
          // most into the s_b_rows pad); those products are discarded.
          uint32_t bf[4];
          load_b_frag_nk(bf, sb + (colw + np * 16) * S_LDK + ks * 16, S_LDK, lane);
          mma_bf16(acc[2 * np], af, bf[0], bf[1]);
          if (2 * np + 1 < nt) mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // x' = bf16(x + (acc + bo) * ls), staged in fp32 for the statistics.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < S_MAXNT; ++j) {
    if (j < nt) {
      const int col = colw + j * 8 + 2 * t;
      const float bo0 = __bfloat162float(bo[col]), bo1 = __bfloat162float(bo[col + 1]);
      const float ls0 = __bfloat162float(ls[col]), ls1 = __bfloat162float(ls[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 16 + g + 8 * half;
        const __nv_bfloat162 xr =
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(row0 + rl) * c + col);
        const float v0 = __bfloat162float(xr.x) + (acc[j][2 * half] + bo0) * ls0;
        const float v1 = __bfloat162float(xr.y) + (acc[j][2 * half + 1] + bo1) * ls1;
        sX[rl * ldx + col] = __bfloat162float(__float2bfloat16_rn(v0));
        sX[rl * ldx + col + 1] = __bfloat162float(__float2bfloat16_rn(v1));
      }
    }
  }
  __syncthreads();

  // LayerNorm: each warp finishes S_BM / 16 = 2 whole rows.
  for (int rr = 0; rr < S_BM / 16; ++rr) {
    const int rl = warp * (S_BM / 16) + rr;
    const float* xs = sX + rl * ldx;
    float s1 = 0.f, s2 = 0.f;
    for (int cc = 2 * lane; cc < c; cc += 64) {
      const float v0 = xs[cc], v1 = xs[cc + 1];
      s1 += v0 + v1;
      s2 += v0 * v0 + v1 * v1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffff, s1, off);
      s2 += __shfl_xor_sync(0xffffffff, s2, off);
    }
    const float m1 = s1 / c, m2 = s2 / c;
    const float rstd = rsqrtf(fmaxf(m2 - m1 * m1, 0.f) + eps);
    const size_t rowoff = (size_t)(row0 + rl) * c;
    for (int cc = 2 * lane; cc < c; cc += 64) {
      const float v0 = xs[cc], v1 = xs[cc + 1];
      *reinterpret_cast<__nv_bfloat162*>(xn + rowoff + cc) = __floats2bfloat162_rn(v0, v1);
      const float y0 = (v0 - m1) * rstd * __bfloat162float(lw[cc]) + __bfloat162float(lb[cc]);
      const float y1 =
          (v1 - m1) * rstd * __bfloat162float(lw[cc + 1]) + __bfloat162float(lb[cc + 1]);
      *reinterpret_cast<__nv_bfloat162*>(hout + rowoff + cc) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

// ---------------------------------------------------------------------------
// D = 64: the cluster wgmma kernel
// ---------------------------------------------------------------------------

constexpr int E_BM = 64;           // rows of a tile
constexpr int E_BK = 64;           // K a stage: one head
constexpr int E_ATOM = 64 * 64;    // elements of a 64 x 64 swizzled atom
constexpr int E_MAX_SMEM = 232448;  // dynamic shared memory one block may use
constexpr int E_MAX_STAGES = 4;
constexpr int E_CLUSTER = 2;  // blocks of a cluster: a row's two halves

// NC consumer warpgroups of WN columns each.
template <int NC, int WN>
struct Epi {
  static constexpr int BW = NC * WN;  // columns a block
  static constexpr int THREADS = 128 * (NC + 1);
  // Rows of one Wo box: the widest of 256, 192, 128, 64 dividing BW.
  static constexpr int WB = BW % 256 == 0 ? 256 : BW % 192 == 0 ? 192 : BW % 128 == 0 ? 128 : 64;
  static constexpr int STAGE_BYTES = E_BM * E_BK * 2 + BW * E_BK * 2;
  static constexpr int X_BYTES = E_BM * BW * 2;
  // the bf16 vectors bo, ls, lw, lb of the block's columns; two buffers
  // of (sum, sum of squares) partials per consumer warpgroup and row; the
  // barriers
  static constexpr int TAIL = 4 * BW * 2 + 2 * NC * E_BM * 8 + (2 * E_MAX_STAGES + 4) * 8;
  static constexpr int FIXED = 1024 + X_BYTES + TAIL;
  static constexpr int FIT = (E_MAX_SMEM - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT < E_MAX_STAGES ? FIT : E_MAX_STAGES;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(BW % 64 == 0 && WN % 64 == 0, "whole 64-column atoms");
};

template <int NC, int WN>
__global__ void __launch_bounds__(Epi<NC, WN>::THREADS, 1)
    attn_epilogue_wgmma(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_xn,
                        const __grid_constant__ CUtensorMap map_h, const bf16* __restrict__ bo,
                        const bf16* __restrict__ ls, const bf16* __restrict__ lw,
                        const bf16* __restrict__ lb, int n, int c, int heads, int row_tiles,
                        float eps) {
  using namespace s3od::hopper;
  using E = Epi<NC, WN>;
  constexpr int BW = E::BW, STAGES = E::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // ring: [STAGES][A 64 x 64 | Wo BW x 64], swizzled; x / x' / h staging
  // [BW / 64][64][64], swizzled
  bf16* sx = reinterpret_cast<bf16*>(base + STAGES * E::STAGE_BYTES);
  bf16* svec = reinterpret_cast<bf16*>(base + STAGES * E::STAGE_BYTES + E::X_BYTES);  // [4][BW]
  float2* red = reinterpret_cast<float2*>(svec + 4 * BW);             // [2][NC][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * NC * E_BM);
  uint64_t* empty = full + STAGES;
  uint64_t* x_full = empty + STAGES;
  uint64_t* x_empty = x_full + 1;
  uint64_t* stat = x_full + 2;  // [2]: both halves' partials of a tile are in

  const uint32_t cc = cluster_ctarank();  // the block's half of the row
  const uint32_t partner = cc ^ 1;
  const int col0 = cc * BW;
  const int cluster = blockIdx.x / E_CLUSTER, clusters = gridDim.x / E_CLUSTER;

  for (int i = threadIdx.x; i < BW; i += E::THREADS) {
    svec[i] = bo[col0 + i];
    svec[BW + i] = ls[col0 + i];
    svec[2 * BW + i] = lw[col0 + i];
    svec[3 * BW + i] = lb[col0 + i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);  // one arrival a consumer warpgroup
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, NC);
    // the quad leaders of both blocks
    for (int b = 0; b < 2; ++b) mbar_init(&stat[b], 32 * NC * E_CLUSTER);
    fence_barrier_init();
  }
  __syncthreads();
  cluster_sync();  // the partner's barriers are initialised

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (NC > 1) setmaxnreg_dec<ws_producer_regs(NC)>();
    if (threadIdx.x == 0) {
      // x of a tile is loaded once the ring is full: its slot frees when
      // the consumers start the tile (the last tile's h store has read it)
      const int x_at = (STAGES < heads ? STAGES : heads) - 1;
      int stage = 0, phase = 0, it = 0;
      for (int rt = cluster; rt < row_tiles; rt += clusters, ++it) {
        const int row0 = rt * E_BM, bi = row0 / n, tok0 = row0 - bi * n;
        for (int kb = 0; kb < heads; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], E::STAGE_BYTES);
          bf16* sa = reinterpret_cast<bf16*>(base + stage * E::STAGE_BYTES);
          bf16* sw = sa + E_BM * E_BK;
          tma_load_3d(sa, &map_a, &full[stage], 0, tok0, bi * heads + kb);
          for (int ch = 0; ch < BW / E::WB; ++ch)
            tma_load_2d(sw + ch * E::WB * E_BK, &map_w, &full[stage], kb * E_BK,
                        col0 + ch * E::WB);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
          if (kb == x_at) {
            mbar_wait(x_empty, (it & 1) ^ 1);
            mbar_expect_tx(x_full, E::X_BYTES);
            for (int a = 0; a < BW / 64; ++a)
              tma_load_2d(sx + a * E_ATOM, &map_x, x_full, col0 + a * 64, row0);
          }
        }
      }
    }
  } else {
    if constexpr (NC > 1) setmaxnreg_inc<ws_consumer_regs(NC)>();
    const int g = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t & 31;
    const int row_w = (t >> 5) * 16 + (lane >> 2);  // fragment row in the 64
    const int col_in = 2 * (lane & 3);
    const int gcol = g * WN;  // the warpgroup's first column in the block
    float acc[WN / 2];
    int stage = 0, phase = 0, it = 0;
    bool pending = false;  // an h store that has not yet read the x slot
    for (int rt = cluster; rt < row_tiles; rt += clusters, ++it) {
      const int row0 = rt * E_BM;
      int prev = 0;
      for (int kb = 0; kb < heads; ++kb) {
        mbar_wait(&full[stage], phase);
        const bf16* sa = reinterpret_cast<const bf16*>(base + stage * E::STAGE_BYTES);
        const bf16* sw = sa + E_BM * E_BK + gcol * E_BK;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < E_BK / 16; ++kk)
          WgmmaSS<WN>::mma(acc, desc_sw128(sa + kk * 16), desc_sw128(sw + kk * 16),
                           (kb | kk) != 0);
        wgmma_commit();
        // under the first products: the last tile's h store has read the
        // x slot, which the producer may now refill
        if (kb == 0 && pending) {
          if (t == 0) {
            tma_store_wait_read();
            mbar_arrive(x_empty);
          }
          pending = false;
        }
        wgmma_wait<1>();
        // a stage is freed once this warpgroup's products on it completed
        if (kb > 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(&empty[prev]);

      // x' = bf16(x + (acc + bo) * ls), over x in the staging atoms (element
      // (row, col) of atom col / 64 at row * 64 + (((col % 64) / 8) ^ (row
      // % 8)) * 8 + col % 8: TMA's 128-byte swizzle), kept in acc as fp32
      mbar_wait(x_full, it & 1);
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
      // in chunks of 8 column groups, every load before any store, so that
      // the shared-memory latencies overlap
      constexpr int JC = 8;
#pragma unroll
      for (int j0 = 0; j0 < WN / 8; j0 += JC) {
        __nv_bfloat162* p[JC][2];
        float2 xv[JC][2];
#pragma unroll
        for (int jj = 0; jj < JC; ++jj) {
          const int col = gcol + 8 * (j0 + jj) + col_in;
          bf16* atom = sx + (col >> 6) * E_ATOM;
          const int cl = col & 63;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = row_w + 8 * hr;
            p[jj][hr] = reinterpret_cast<__nv_bfloat162*>(
                atom + row * 64 + (((cl >> 3) ^ (row & 7)) << 3) + (cl & 7));
            xv[jj][hr] = __bfloat1622float2(*p[jj][hr]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < JC; ++jj) {
          const int j = j0 + jj, col = gcol + 8 * j + col_in;
          const float2 b2 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(svec + col));
          const float2 l2 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(svec + BW + col));
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const __nv_bfloat162 r = __floats2bfloat162_rn(
                xv[jj][hr].x + (acc[4 * j + 2 * hr] + b2.x) * l2.x,
                xv[jj][hr].y + (acc[4 * j + 2 * hr + 1] + b2.y) * l2.y);
            *p[jj][hr] = r;
            const float2 rv = __bfloat1622float2(r);
            acc[4 * j + 2 * hr] = rv.x;
            acc[4 * j + 2 * hr + 1] = rv.y;
            s1[hr] += rv.x + rv.y;
            s2[hr] += rv.x * rv.x + rv.y * rv.y;
          }
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          s1[hr] += __shfl_xor_sync(0xffffffff, s1[hr], off);
          s2[hr] += __shfl_xor_sync(0xffffffff, s2[hr], off);
        }
      fence_proxy_async();
      named_sync(1 + g, 128);
      if (t == 0) {
        for (int a = 0; a < WN / 64; ++a)
          tma_store_2d(&map_xn, sx + (gcol / 64 + a) * E_ATOM, col0 + gcol + a * 64, row0);
        tma_store_commit();
      }
      // Row statistics: the quad leaders post this warpgroup's partials
      // and arrive here and on the partner; then each leader sums every
      // warpgroup's partials of both halves, in column order.
      const int buf = it & 1;
      float2* rb = red + buf * NC * E_BM;
      if ((lane & 3) == 0) {
        rb[g * E_BM + row_w] = make_float2(s1[0], s2[0]);
        rb[g * E_BM + row_w + 8] = make_float2(s1[1], s2[1]);
        mbar_arrive(&stat[buf]);
        mbar_arrive_cluster(&stat[buf], partner);
      }
      mbar_wait_cluster(&stat[buf], (it >> 1) & 1);
      float m1[2], rstd[2];
      float2 part[2][E_CLUSTER][NC];  // every load issued before the sums
      if ((lane & 3) == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int q = 0; q < E_CLUSTER; ++q)
#pragma unroll
            for (int gg = 0; gg < NC; ++gg) {
              const float2* p = rb + gg * E_BM + row_w + 8 * hr;
              part[hr][q][gg] = q == cc ? *p : ld_shared_cluster_f2(p, partner);
            }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float a1 = 0.f, a2 = 0.f;
        if ((lane & 3) == 0) {
#pragma unroll
          for (int q = 0; q < E_CLUSTER; ++q)
#pragma unroll
            for (int gg = 0; gg < NC; ++gg) {
              a1 += part[hr][q][gg].x;
              a2 += part[hr][q][gg].y;
            }
        }
        a1 = __shfl_sync(0xffffffff, a1, lane & ~3);
        a2 = __shfl_sync(0xffffffff, a2, lane & ~3);
        m1[hr] = a1 / c;
        rstd[hr] = rsqrtf(fmaxf(a2 / c - m1[hr] * m1[hr], 0.f) + eps);
      }
      // h over x' once the x' store has read it
      if (t == 0) tma_store_wait_read();
      named_sync(1 + g, 128);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = gcol + 8 * j + col_in;
        const float2 w2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(svec + 2 * BW + col));
        const float2 b2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(svec + 3 * BW + col));
        bf16* atom = sx + (col >> 6) * E_ATOM;
        const int cl = col & 63;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = row_w + 8 * hr;
          *reinterpret_cast<__nv_bfloat162*>(atom + row * 64 + (((cl >> 3) ^ (row & 7)) << 3) +
                                             (cl & 7)) =
              __floats2bfloat162_rn((acc[4 * j + 2 * hr] - m1[hr]) * rstd[hr] * w2.x + b2.x,
                                    (acc[4 * j + 2 * hr + 1] - m1[hr]) * rstd[hr] * w2.y + b2.y);
        }
      }
      fence_proxy_async();
      named_sync(1 + g, 128);
      if (t == 0) {
        for (int a = 0; a < WN / 64; ++a)
          tma_store_2d(&map_h, sx + (gcol / 64 + a) * E_ATOM, col0 + gcol + a * 64, row0);
        tma_store_commit();
      }
      pending = true;
    }
    if (t == 0) tma_store_wait_all();
  }
  // no block leaves while its partners may still read or arrive on its
  // shared memory
  cluster_sync();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int NC, int WN>
int launch_wgmma(const void* a, const void* wo, const void* bo, const void* x, const void* ls,
                 const void* lw, const void* lb, void* xn, void* h, int batch, int n, int c,
                 int heads, float eps, cudaStream_t st) {
  using namespace s3od::hopper;
  using E = Epi<NC, WN>;
  CUtensorMap map_a, map_w, map_x, map_xn, map_h;
  const uint64_t dims_a[3] = {(uint64_t)E_BK, (uint64_t)n, (uint64_t)batch * heads};
  const uint64_t strides_a[2] = {(uint64_t)E_BK * 2, (uint64_t)n * E_BK * 2};
  const uint32_t box_a[3] = {E_BK, E_BM, 1};
  const uint64_t dims_w[2] = {(uint64_t)c, (uint64_t)c};
  const uint64_t strides_w[1] = {(uint64_t)c * 2};
  const uint32_t box_w[2] = {E_BK, E::WB};
  const uint64_t dims_x[2] = {(uint64_t)c, (uint64_t)batch * n};
  const uint64_t strides_x[1] = {(uint64_t)c * 2};
  const uint32_t box_x[2] = {64, E_BM};
  int err = encode_bf16_map(&map_a, a, 3, dims_a, strides_a, box_a);
  if (!err) err = encode_bf16_map(&map_w, wo, 2, dims_w, strides_w, box_w);
  if (!err) err = encode_bf16_map(&map_x, x, 2, dims_x, strides_x, box_x);
  if (!err) err = encode_bf16_map(&map_xn, xn, 2, dims_x, strides_x, box_x);
  if (!err) err = encode_bf16_map(&map_h, h, 2, dims_x, strides_x, box_x);
  if (err) return err;
  auto kernel = attn_epilogue_wgmma<NC, WN>;
  cudaError_t e;
  // once per process (per instance): the opt-in above 48 KB and the
  // clusters resident at once on this card (GPCs hold whole clusters),
  // which bound the persistent grid
  static int max_clusters = 0;
  if (max_clusters <= 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, E::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int row_tiles = batch * n / E_BM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = E_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * E_CLUSTER);
  cfg.blockDim = dim3(E::THREADS);
  cfg.dynamicSmemBytes = E::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters <= 0) {
    e = cudaOccupancyMaxActiveClusters(&max_clusters, reinterpret_cast<const void*>(kernel), &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (max_clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cfg.gridDim = dim3((row_tiles < max_clusters ? row_tiles : max_clusters) * E_CLUSTER);
  e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_w, map_x, map_xn, map_h,
                         static_cast<const bf16*>(bo), static_cast<const bf16*>(ls),
                         static_cast<const bf16*>(lw), static_cast<const bf16*>(lb), n, c, heads,
                         row_tiles, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The instance for c columns: C / 2 a block, in consumer warpgroups of at
// most 256 (mirrored by `s3od_torch/ops/attn_epilogue.py:WIDTHS`).
int launch_d64(const void* a, const void* wo, const void* bo, const void* x, const void* ls,
               const void* lw, const void* lb, void* xn, void* h, int batch, int n, int c,
               int heads, float eps, cudaStream_t st) {
#define S3OD_EPI(NC, WN) \
  launch_wgmma<NC, WN>(a, wo, bo, x, ls, lw, lb, xn, h, batch, n, c, heads, eps, st)
  switch (c) {
    case 128: return S3OD_EPI(1, 64);
    case 256: return S3OD_EPI(1, 128);
    case 384: return S3OD_EPI(1, 192);
    case 512: return S3OD_EPI(1, 256);
    case 768: return S3OD_EPI(2, 192);
    case 1024: return S3OD_EPI(2, 256);
  }
#undef S3OD_EPI
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: (batch*heads, n, d); wo: (c, c); x, xn, h: (batch, n, c); vectors
// (c,), all bf16 and contiguous; n a multiple of 64. d = 64 runs the
// cluster wgmma kernel (c in {128, 256, 384, 512, 768, 1024}, every pointer
// 16-byte aligned); d = 32 the mma.sync kernel (c a multiple of 64 up to
// 1024). Anything else is refused (checked by the Python wrapper as well).
extern "C" int s3od_attn_epilogue(const void* a, const void* wo, const void* bo,
                                  const void* x, const void* ls, const void* lw,
                                  const void* lb, void* xn, void* h, int batch, int n,
                                  int c, int heads, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n <= 0 || n % 64 || c <= 0 || c % 64 || heads * d != c)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == E_BK) {
    const void* ptrs[9] = {a, wo, bo, x, ls, lw, lb, xn, h};
    for (const void* p : ptrs)
      if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_d64(a, wo, bo, x, ls, lw, lb, xn, h, batch, n, c, heads, eps, st);
  }
  if (d != 32 || c > 8 * 8 * S_MAXNT) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = s_smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      attn_epilogue_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(batch * n / S_BM);
  attn_epilogue_mma_kernel<<<grid, S_THREADS, bytes, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<const bf16*>(x),
      static_cast<const bf16*>(ls), static_cast<const bf16*>(lw),
      static_cast<const bf16*>(lb), static_cast<bf16*>(xn), static_cast<bf16*>(h), n, c,
      heads, d, eps);
  return static_cast<int>(cudaGetLastError());
}
