// K2: fused QKV projection + RoPE, head-major output.
//
// Replaces the TPU kernel `s3od_tpu/ops/qkv_project.py:_kernel` (via
// `qkv_project_rope`). For x (B, N, C) and the fused nn.Linear-layout
// weight W (3C, C) it computes y = x @ W^T + b with fp32 accumulation and,
// in the epilogue:
//   - q, k: y * cos + rot(bf16(y)) * sin in fp32, where rot is rotate-half
//     of the bf16-ROUNDED y (the TPU kernel rotates with a +-1 bf16 matmul
//     on the rounded y, `qkv_project.py:94-99`);
//   - q additionally * D^-1/2 in fp32, so attention runs with scale 1;
//   - one rounding to bf16, stored straight into the (B, H, N, D) layout
//     K3 reads.
// The TPU's head-pair packing is a lane layout and is not ported.
//
// Bound on the H100: at ViT-B, 1024^2 b1 (M = 4160, K = 768, N = 2304)
// this is a 14.7 GFLOP product over ~31 MB (x, W, the three outputs and
// the fp32 tables), 0.0149 ms at 989 TFLOP/s: compute-bound by a small
// margin.
//
// D = 64 (ViT-B, ViT-L): K5's warp-specialised, persistent wgmma GEMM with
// a RoPE epilogue (`qkv_wgmma_kernel`):
//   - a grid of min(tiles, SMs) blocks walks output tiles of 128 tokens
//     of one batch element x BN columns (BN = 192, 128 or 64, whole heads
//     of one of q, k, v; `pick_bn`), columns fastest; x is read through a
//     3-D (C, N, B) tensor map, so a tile never straddles two batch
//     elements and rows past N load as zeros (33 row tiles at N = 4160);
//   - one producer thread keeps a 4-stage ring of TMA loads (128 x 64 of
//     x, BN x 64 of W, 128-byte swizzle) in flight; two consumer
//     warpgroups of 232 registers run SS wgmma m64nBNk16 on 64 rows each,
//     one stage's group in flight while the next is issued;
//   - RoPE in registers: a thread's accumulator holds columns 8 i + 2 (t %
//     4) + {0, 1} of its rows, so the rotate-half partner (column +-32 of
//     the head) is its own register group i +- 4; cos and sin (fp32, (N,
//     64)) are read as float2 pairs at the start of the tile, so that
//     their latency hides under the products, and serve every head of it;
//   - the bf16 results are staged in shared memory in the 128-byte swizzle
//     and stored by TMA through 3-D (64, N, B H) maps of q, k and v, one
//     64 x 64 box per head, which clip the rows past N; the store of one
//     tile runs while the next tile's products do.
// On the H100 at ViT-B 1024^2 b1 it runs at ~40% of its bound, beside
// cuBLAS's bare x W^T + b at ~50%. Not isolated: the 128 x 192 tile
// brings ~77 FLOP a byte of its operands from L2, likely short of feeding
// the tensor cores at their rate (a 2-CTA cluster sharing W's tiles is
// the next thing to try).
// D = 32 (the tiny checkpoints) keeps the mma.sync kernel (`qkv_rope_kernel`): a
// 64 x 64 x 64 tile, a two-stage cp.async pipeline feeding mma.sync, the
// partner column read back from shared memory; the entry point dispatches
// on D.
#include "hopper.cuh"  // and mma.cuh

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// D = 32: the mma.sync kernel
// ---------------------------------------------------------------------------

constexpr int S_BM = 64, S_BN = 64, S_BK = 64, S_LDS = S_BK + 8, S_THREADS = 128;  // the D = 32 kernel

__global__ void __launch_bounds__(S_THREADS)
    qkv_rope_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, bf16* __restrict__ q,
                    bf16* __restrict__ k, bf16* __restrict__ v, int n, int c, int heads,
                    int d, float scale) {
  __shared__ __align__(16) bf16 sA[2][S_BM][S_LDS];
  __shared__ __align__(16) bf16 sB[2][S_BN][S_LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * S_BM;
  const int col0 = blockIdx.y * S_BN;  // column in [0, 3C)
  const bf16* xa = x + (size_t)row0 * c;
  const bf16* wb = w + (size_t)col0 * c;

  auto load_stage = [&](int stage, int k0) {
    for (int i = tid; i < S_BM * (S_BK / 8); i += S_THREADS) {
      const int r = i >> 3, cc = (i & 7) * 8;
      cp_async16(&sA[stage][r][cc], xa + (size_t)r * c + k0 + cc);
      cp_async16(&sB[stage][r][cc], wb + (size_t)r * c + k0 + cc);
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
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
    const int s = kt & 1;
#pragma unroll
    for (int ks = 0; ks < S_BK / 16; ++ks) {
      uint32_t a[4];
      load_a_frag(a, &sA[s][warp * 16][ks * 16], S_LDS, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_b_frag_nk(b, &sB[s][np * 16][ks * 16], S_LDS, lane);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  const int seg = col0 / c;         // 0 = q, 1 = k, 2 = v
  const int cseg = col0 - seg * c;  // first column of the tile inside its segment
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = nt * 8 + 2 * t;
    const float b0 = __bfloat162float(bias[col0 + j]);
    const float b1 = __bfloat162float(bias[col0 + j + 1]);
    acc[nt][0] += b0;
    acc[nt][1] += b1;
    acc[nt][2] += b0;
    acc[nt][3] += b1;
  }

  // bf16(y) of the whole tile, for the rotate-half partner reads.
  bf16(*sY)[S_LDS] = sA[0];
  if (seg < 2) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = nt * 8 + 2 * t;
      const int r = warp * 16 + g;
      *reinterpret_cast<uint32_t*>(&sY[r][j]) = pack_bf16(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(&sY[r + 8][j]) = pack_bf16(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
  }

  bf16* out = seg == 0 ? q : (seg == 1 ? k : v);
  const int half_d = d / 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = nt * 8 + 2 * t;  // column inside the tile (even)
    const int cc = cseg + j;
    const int h = cc / d, jh = cc - h * d;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = warp * 16 + g + 8 * half;
      const int r = row0 + rl;
      const int bb = r / n, tok = r - bb * n;
      float y0 = acc[nt][2 * half], y1 = acc[nt][2 * half + 1];
      if (seg < 2) {
        const bool lo = jh < half_d;
        const int partner = lo ? j + half_d : j - half_d;
        const float sign = lo ? -1.f : 1.f;
        const float r0 = sign * __bfloat162float(sY[rl][partner]);
        const float r1 = sign * __bfloat162float(sY[rl][partner + 1]);
        const float* ct = cos_t + (size_t)tok * d + jh;
        const float* st = sin_t + (size_t)tok * d + jh;
        y0 = y0 * ct[0] + r0 * st[0];
        y1 = y1 * ct[1] + r1 * st[1];
        if (seg == 0) {
          y0 *= scale;
          y1 *= scale;
        }
      }
      const size_t off = (((size_t)bb * heads + h) * n + tok) * d + jh;
      *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(y0, y1);
    }
  }
}


// ---------------------------------------------------------------------------
// D = 64: the warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

constexpr int W_BM = 128, W_BK = 64, W_THREADS = 384, W_STAGES = 4, W_D = 64;
constexpr int W_PRODUCER_REGS = 40, W_CONSUMER_REGS = 232;
constexpr int W_ATOM = 64 * 64;  // elements of a 64-row x 64-column staging atom: one head

template <int BN>
__host__ __device__ constexpr int w_smem_bytes() {
  // 1024 bytes of slack to align the ring; the x and W stages; two 64 x BN
  // staging tiles; a full and an empty barrier per stage.
  return 1024 + W_STAGES * (W_BM + BN) * W_BK * 2 + 2 * 64 * BN * 2 + 2 * W_STAGES * 8;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int BN>
__global__ void __launch_bounds__(W_THREADS, 1)
    qkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ bias,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t, int n,
                     int c, int batch, int heads, float scale) {
  using namespace s3od::hopper;
  constexpr int NH = BN / 64;  // heads of a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sA = reinterpret_cast<bf16*>(base);  // [W_STAGES][W_BM][W_BK], swizzled
  bf16* sB = sA + W_STAGES * W_BM * W_BK;     // [W_STAGES][BN][W_BK], swizzled
  bf16* sC = sB + W_STAGES * BN * W_BK;       // [2][NH][64][64], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + 2 * 64 * BN);
  uint64_t* empty = full + W_STAGES;

  const int row_tiles = (n + W_BM - 1) / W_BM;
  const int n_tiles = 3 * c / BN;
  const int tiles = batch * row_tiles * n_tiles;
  const int kblocks = c / W_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<W_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tm = tile / n_tiles, tn = tile - tm * n_tiles;
        const int bi = tm / row_tiles, rt = tm - bi * row_tiles;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (W_BM + BN) * W_BK * 2);
          tma_load_3d(sA + stage * W_BM * W_BK, &map_x, &full[stage], kb * W_BK, rt * W_BM, bi);
          tma_load_2d(sB + stage * BN * W_BK, &map_w, &full[stage], kb * W_BK, tn * BN);
          if (++stage == W_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<W_CONSUMER_REGS>();
  const int half = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int row_w = (t >> 5) * 16 + ((t & 31) >> 2);  // fragment row in the 64
  const int col_in = 2 * (t & 3);
  bf16* stage_c = sC + half * 64 * BN;
  float acc[BN / 2];
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tm = tile / n_tiles, tn = tile - tm * n_tiles;
    const int bi = tm / row_tiles, rt = tm - bi * row_tiles;
    const int tok0 = rt * W_BM + half * 64;
    const int col0 = tn * BN;  // first column of the tile in [0, 3C)
    const int seg = col0 / c;  // 0 = q, 1 = k, 2 = v
    if (t == 0) tma_store_wait_read();  // the previous tile's store has read stage_c
    // cos and sin of this thread's rows and column pairs (and their
    // partners), loaded now so that their latency hides under the products
    float2 cs[2][4][4];  // [row half][i][cos lo, sin lo, cos hi, sin hi]
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int tok = min(tok0 + row_w + 8 * hr, n - 1);  // rows past N are not stored
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t at = (size_t)tok * W_D + 8 * i + col_in;
        cs[hr][i][0] = cs[hr][i][2] = make_float2(1.f, 1.f);
        cs[hr][i][1] = cs[hr][i][3] = make_float2(0.f, 0.f);
        if (seg < 2) {
          cs[hr][i][0] = *reinterpret_cast<const float2*>(cos_t + at);
          cs[hr][i][1] = *reinterpret_cast<const float2*>(sin_t + at);
          cs[hr][i][2] = *reinterpret_cast<const float2*>(cos_t + at + 32);
          cs[hr][i][3] = *reinterpret_cast<const float2*>(sin_t + at + 32);
        }
      }
    }
    // One wgmma group stays in flight: a stage is released once the next
    // stage's products are issued and its own have completed.
    int prev = 0;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const bf16* a = sA + stage * W_BM * W_BK + half * 64 * W_BK;
      const bf16* b = sB + stage * BN * W_BK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BK / 16; ++kk)
        WgmmaSS<BN>::mma(acc, desc_sw128(a + kk * 16), desc_sw128(b + kk * 16), (kb | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == W_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    // Epilogue: y = acc + b; for q and k, y cos + rot(bf16(y)) sin (q
    // also x scale); rounded once into the staging tile (element (row,
    // col) of head hd in atom hd, row `row`, 16-byte chunk (col / 8) ^
    // (row % 8): TMA's 128-byte swizzle).
    named_sync(1 + half, 128);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row_w + 8 * hr;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dl = 8 * i + col_in, dh = dl + 32;  // the pair and its partner
        const float2 cl = cs[hr][i][0], sl = cs[hr][i][1], ch = cs[hr][i][2], sh = cs[hr][i][3];
#pragma unroll
        for (int hd = 0; hd < NH; ++hd) {
          const int jl = 8 * hd + i, jh = jl + 4;
          const float2 bl = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + col0 + 64 * hd + dl));
          const float2 bh = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + col0 + 64 * hd + dh));
          float yl0 = acc[4 * jl + 2 * hr] + bl.x, yl1 = acc[4 * jl + 2 * hr + 1] + bl.y;
          float yh0 = acc[4 * jh + 2 * hr] + bh.x, yh1 = acc[4 * jh + 2 * hr + 1] + bh.y;
          if (seg < 2) {
            const float ol0 = yl0 * cl.x + -round_bf16(yh0) * sl.x;
            const float ol1 = yl1 * cl.y + -round_bf16(yh1) * sl.y;
            const float oh0 = yh0 * ch.x + round_bf16(yl0) * sh.x;
            const float oh1 = yh1 * ch.y + round_bf16(yl1) * sh.y;
            yl0 = ol0, yl1 = ol1, yh0 = oh0, yh1 = oh1;
            if (seg == 0) {
              yl0 *= scale, yl1 *= scale, yh0 *= scale, yh1 *= scale;
            }
          }
          bf16* atom = stage_c + hd * W_ATOM + row * 64;
          *reinterpret_cast<uint32_t*>(atom + (((dl >> 3) ^ (row & 7)) << 3) + (dl & 7)) =
              pack_bf16(yl0, yl1);
          *reinterpret_cast<uint32_t*>(atom + (((dh >> 3) ^ (row & 7)) << 3) + (dh & 7)) =
              pack_bf16(yh0, yh1);
        }
      }
    }
    fence_proxy_async();
    named_sync(1 + half, 128);
    if (t == 0) {
      const CUtensorMap* mo = seg == 0 ? &map_q : (seg == 1 ? &map_k : &map_v);
      const int head0 = (col0 - seg * c) / W_D;
#pragma unroll
      for (int hd = 0; hd < NH; ++hd)
        tma_store_3d(mo, stage_c + hd * W_ATOM, 0, tok0, bi * heads + head0 + hd);
      tma_store_commit();
    }
  }
  if (t == 0) tma_store_wait_all();
}

// The tile width for c input channels and `tiles_bn1` = batch x row tiles:
// of the widths that divide c (so that a tile holds whole heads of one of
// q, k, v), the one whose waves over `sms` blocks cost the least (waves x
// BN), the wider on a tie (fewer re-reads of x).
int pick_bn(int c, long long row_tiles, int sms) {
  const int widths[3] = {192, 128, 64};
  int best = 0;
  long long best_cost = 0;
  for (int bn : widths) {
    if (c % bn) continue;
    const long long tiles = row_tiles * (3 * c / bn);
    const long long cost = (tiles + sms - 1) / sms * bn;
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, const void* b, const void* cos_t,
                 const void* sin_t, void* q, void* k, void* v, int batch, int n, int c, int heads,
                 float scale, int sms, cudaStream_t st) {
  using namespace s3od::hopper;
  CUtensorMap map_x, map_w, map_o[3];
  const uint64_t dims_x[3] = {(uint64_t)c, (uint64_t)n, (uint64_t)batch};
  const uint64_t strides_x[2] = {(uint64_t)c * 2, (uint64_t)n * c * 2};
  const uint32_t box_x[3] = {W_BK, W_BM, 1};
  const uint64_t dims_w[2] = {(uint64_t)c, (uint64_t)3 * c};
  const uint64_t strides_w[1] = {(uint64_t)c * 2};
  const uint32_t box_w[2] = {W_BK, BN};
  const uint64_t dims_o[3] = {W_D, (uint64_t)n, (uint64_t)batch * heads};
  const uint64_t strides_o[2] = {W_D * 2, (uint64_t)n * W_D * 2};
  const uint32_t box_o[3] = {64, 64, 1};
  int err = encode_bf16_map(&map_x, x, 3, dims_x, strides_x, box_x);
  if (!err) err = encode_bf16_map(&map_w, w, 2, dims_w, strides_w, box_w);
  void* outs[3] = {q, k, v};
  for (int i = 0; i < 3 && !err; ++i)
    err = encode_bf16_map(&map_o[i], outs[i], 3, dims_o, strides_o, box_o);
  if (err) return err;
  constexpr int smem = w_smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(qkv_wgmma_kernel<BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (long long)batch * ((n + W_BM - 1) / W_BM) * (3 * c / BN);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  qkv_wgmma_kernel<BN><<<grid, W_THREADS, smem, st>>>(
      map_x, map_w, map_o[0], map_o[1], map_o[2], static_cast<const bf16*>(b),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), n, c, batch, heads,
      scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: (batch, n, c); w: (3c, c); b: (3c,) bf16; cos_t, sin_t: (n, d) fp32;
// q, k, v: (batch, heads, n, d) bf16, all contiguous. d = 64 runs the
// wgmma kernel (c a multiple of 64; every pointer 16-byte aligned); d = 32
// the mma.sync kernel (n and c multiples of 64). Anything else is refused
// (checked by the Python wrapper as well).
extern "C" int s3od_qkv_project_rope(const void* x, const void* w, const void* b,
                                     const void* cos_t, const void* sin_t, void* q,
                                     void* k, void* v, int batch, int n, int c, int heads,
                                     int d, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n <= 0 || c <= 0 || c % 64 || heads * d != c)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == W_D) {
    const void* ptrs[8] = {x, w, b, cos_t, sin_t, q, k, v};
    for (const void* p : ptrs)
      if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
    const int sms = s3od::hopper::sm_count();
    const long long row_tiles = (long long)batch * ((n + W_BM - 1) / W_BM);
    switch (pick_bn(c, row_tiles, sms)) {
      case 192:
        return launch_wgmma<192>(x, w, b, cos_t, sin_t, q, k, v, batch, n, c, heads, scale, sms, st);
      case 128:
        return launch_wgmma<128>(x, w, b, cos_t, sin_t, q, k, v, batch, n, c, heads, scale, sms, st);
      case 64:
        return launch_wgmma<64>(x, w, b, cos_t, sin_t, q, k, v, batch, n, c, heads, scale, sms, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d != 32 || n % S_BM) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(batch * n / S_BM, 3 * c / S_BN);
  qkv_rope_kernel<<<grid, S_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(q), static_cast<bf16*>(k),
      static_cast<bf16*>(v), n, c, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
}
