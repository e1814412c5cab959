// K9a: the Winograd F(2x2, 3x3) 3x3/stride-1/pad-1 conv + bias, and K9b:
// the chained BN-folded ResidualConvUnit x + conv2(relu(conv1(relu(x)) +
// b1)) + b2, both convs C -> C.
//
// Replace the TPU kernels `s3od_tpu/ops/experimental/winograd.py:_kernel`
// (via `conv3x3_winograd`) and `:_rcu_kernel` (via `rcu_winograd`). x and
// out are (B, H, W, C) in NHWC *logical* order with any strides (the DPT
// decoder passes NCHW memory); w is (3, 3, C, K) bf16, read through its
// strides. Per 2x2 output tile:
//   U   = bf16(G w G^T)            fp32, once a call (`wino_weights_kernel`)
//   V   = bf16(B^T d B)            d the 4x4 input patch, fp32 add/sub
//   M   = V[uv] @ U[uv]            16 products, fp32 accumulation
//   acc += A^T M A                 folded into 4 fp32 accumulators
//   out = bf16(acc + bias)         one rounding (K9b: + b2 + x, one rounding)
// — the TPU kernels' rounding points. The fold is linear, so where it runs
// (once per M, or once per 64-channel slice of M) changes only the fp32
// order of the sums.
//
// What bounds them on the H100: F(2,3) needs 16 C K multiplies per tile
// where a direct 3x3 needs 36, so at the decoder's shapes (e.g. 256^2,
// 256 -> 256: 3.4e10 FLOP, 67 MB) the tensor-core bound (~0.035 ms) is
// above the bytes bound (~0.020 ms). What holds the kernels back is the
// fold: a block cannot own all K output channels, since the four output
// accumulators and a product of 64 x 64 fp32 per warpgroup already take
// 160 registers a thread (192 with K9b's M), so the products run as SS
// wgmma m64n64k16, whose operands (4 KB per k16 step) take the whole of
// shared memory's 128 bytes a cycle at the tensor cores' rate.
//
// Two routes, both on one Winograd GEMM body (TMA ring of U, two consumer
// warpgroups of 64 output channels each, the epilogue staged in shared
// memory and stored in pairs along out's memory order):
//   1. Two launches (K9b's convs; K9a at k > 256 or on strides TMA cannot
//      read): the input transform writes V (16, P, C) bf16 to device
//      memory (a block stages a 4 x 66 pixel x 64 channel region and
//      writes 32 tiles' 16 V rows in 128-byte runs), then the GEMM reads
//      it by TMA: a block owns 64 tiles x 128 output channels, one
//      producer thread loads per (uv, 64-channel chunk) V's 64 x 64 tile
//      and U's 64 x 128 tile into a 6-stage ring, and each consumer
//      warpgroup adds each stage's product into M in fp32 and folds M
//      once per uv. V is 4x the input's bytes; K9a runs in chunks of tile
//      rows whose V fits a bounded scratch (the wrapper's
//      `V_SCRATCH_BYTES`), K9b in one chunk.
//   2. Fused (K9a at k <= 256, `wino_fused_kernel`): V never leaves shared
//      memory. A block owns 2 x 32 tiles x 128 output channels; per
//      64-channel chunk of x one thread loads the block's 6-row region by
//      TMA (zero-filled outside the image) and seven warps of two producer
//      warpgroups write V in two halves of 8 uv into two 64 KB slots in
//      the swizzle wgmma reads, while the consumers read the other slot
//      and fold each (chunk, uv) product as it completes. At k = 128 it
//      saves V's round trip (1.1 GB at 512^2 x 256) and ran 0.39 ms
//      against the two launches' 0.58; at k = 256 the transform runs twice
//      and the two routes measured the same.
// K9b keeps the intermediate h = bf16(relu(conv1 + b1)) in device memory
// (NHWC, 33.5 MB at 256^2 x 256: it is rounded once either way, and conv2
// pads it with zeros either way); conv2's epilogue adds x, whose tile the
// GEMM's idle producer warps copy into shared memory during the products.
#include "hopper.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

struct Strides {
  long long b, h, w, c;
};

// A^T of F(2x2, 3x3): ((1, 1, 1, 0), (0, 1, -1, -1)).
__host__ __device__ constexpr int at(int a, int u) {
  return a == 0 ? (u == 3 ? 0 : 1) : (u == 0 ? 0 : (u == 1 ? 1 : -1));
}

// V = B^T d B of one 4x4 patch d (fp32), in the TPU kernel's order of
// additions: o[u * 4 + v], not yet rounded.
__device__ __forceinline__ void bt_d_b(const float (&d)[4][4], float (&o)[16]) {
  float t[4][4];  // t[u][q] = sum_p B^T[u][p] d[p][q]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    t[0][q] = d[0][q] - d[2][q];
    t[1][q] = d[1][q] + d[2][q];
    t[2][q] = -d[1][q] + d[2][q];
    t[3][q] = d[1][q] - d[3][q];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    o[u * 4 + 0] = t[u][0] - t[u][2];
    o[u * 4 + 1] = t[u][1] + t[u][2];
    o[u * 4 + 2] = -t[u][1] + t[u][2];
    o[u * 4 + 3] = t[u][1] - t[u][3];
  }
}

// How the transform reads its region of x: element by element (any
// strides), in 16-byte row chunks of one channel (NCHW memory), or in
// 16-byte chunks of 8 channels of one pixel (NHWC memory).
enum : int { BY_ELEMENT = 0, BY_ROW = 1, BY_PIXEL = 2 };

int load_mode(const void* x, int w, const Strides& xs) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs.h % 8 == 0 && xs.b % 8 == 0;
  if (aligned && xs.w == 1 && w % 8 == 0 && xs.c % 8 == 0) return BY_ROW;
  if (aligned && xs.c == 1 && xs.w % 8 == 0) return BY_PIXEL;
  return BY_ELEMENT;
}

// U = G w G^T (16, c, k) bf16 of w (3, 3, c, k) bf16 read through strides
// (ws: kernel row, kernel column, c, k, in elements), in fp32 in
// `transform_weights`' order (G over the kernel's rows, then over its
// columns), rounded once: a thread per (c, k), U's rows written in runs of k.
__global__ void __launch_bounds__(256)
    wino_weights_kernel(const bf16* __restrict__ w, bf16* __restrict__ u, int c, int k,
                        Strides ws) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)c * k) return;
  const int ci = static_cast<int>(i / k), ki = static_cast<int>(i - (long long)ci * k);
  const float g[4][3] = {{1.f, 0.f, 0.f}, {0.5f, 0.5f, 0.5f}, {0.5f, -0.5f, 0.5f}, {0.f, 0.f, 1.f}};
  float wv[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      wv[r][q] = __bfloat162float(w[r * ws.b + q * ws.h + ci * ws.w + ki * ws.c]);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float t[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) t[q] = g[a][0] * wv[0][q] + g[a][1] * wv[1][q] + g[a][2] * wv[2][q];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      u[((size_t)(a * 4 + b) * c + ci) * k + ki] =
          __float2bfloat16(g[b][0] * t[0] + g[b][1] * t[1] + g[b][2] * t[2]);
  }
}

// ---------------------------------------------------------------------------
// The input transform and the Winograd GEMM: two launches a conv, for K9a
// and for each of K9b's two convs
// ---------------------------------------------------------------------------

constexpr int T_TC = 32;              // transform: tiles of a block (one tile row)
constexpr int T_CB = 64;              // transform: channels of a block
constexpr int T_RC = 2 * T_TC + 2;    // its region's pixel columns
constexpr int T_LD = T_CB + 2;        // bf16 stride of a region pixel: 33 words, odd
constexpr int T_THREADS = 256;
constexpr int T_BATCH = 8;  // loads in flight a thread

// A region of NR pixel rows (image rows y0 ..) x T_RC pixel columns
// (image columns 2 tc0 - 1 ..) x T_CB channels of xb (its first channel)
// into s_in[(r T_RC + j) T_LD + cc], zero outside the image, ReLU'd if
// asked, by NT threads (`tid`), BATCH 16-byte loads in flight each: in
// chunks of 8 channels of a pixel (NHWC memory, `mode` BY_PIXEL) or of 8
// pixels of a channel's row (NCHW memory, BY_ROW), or element by element.
// The pixel stride of 33 words spreads the shared-memory stores over the
// banks.
template <int NR, int NT, int BATCH, bool RELU>
__device__ __forceinline__ void load_region(bf16* s_in, const bf16* xb, const Strides& xs, int h,
                                            int w, int y0, int tc0, int mode, int tid) {
  const int x0 = 2 * tc0 - 1;
  auto put = [&](int r, int j, int cc, bf16 val) {
    if (RELU) val = __float2bfloat16(fmaxf(__bfloat162float(val), 0.f));
    s_in[(r * T_RC + j) * T_LD + cc] = val;
  };
  auto inside = [&](int r, int j) {
    const int gy = y0 + r, gx = x0 + j;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  };
  if (mode == BY_PIXEL) {
    constexpr int N = NR * T_RC * (T_CB / 8);
    for (int i0 = 0; i0 < N; i0 += BATCH * NT) {
      uint4 val[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * NT + tid, q = i % (T_CB / 8), pix = i / (T_CB / 8);
        const int r = pix / T_RC, j = pix - r * T_RC;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < N && inside(r, j))
          val[u] = *reinterpret_cast<const uint4*>(xb + (y0 + r) * xs.h + (x0 + j) * xs.w + 8 * q);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * NT + tid, q = i % (T_CB / 8), pix = i / (T_CB / 8);
        if (i >= N) continue;
        const bf16* e = reinterpret_cast<const bf16*>(&val[u]);
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) put(pix / T_RC, pix % T_RC, 8 * q + c8, e[c8]);
      }
    }
  } else if (mode == BY_ROW) {
    // from column 2 tc0 - 8 (a multiple of 8): region columns -7 .. 72, of
    // which 0 .. T_RC - 1 are kept; w is a multiple of 8, so a chunk lies
    // wholly inside or outside the image
    constexpr int NQ = (T_RC + 7 + 7) / 8, N = NR * NQ * T_CB;
    for (int i0 = 0; i0 < N; i0 += BATCH * NT) {
      uint4 val[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * NT + tid, q = i % NQ, rest = i / NQ;
        const int r = rest % NR, cc = rest / NR;
        const int gy = y0 + r, gx = 2 * tc0 - 8 + 8 * q;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < N && gy >= 0 && gy < h && gx >= 0 && gx < w)
          val[u] = *reinterpret_cast<const uint4*>(xb + gy * xs.h + gx + cc * xs.c);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * NT + tid, q = i % NQ, rest = i / NQ;
        if (i >= N) continue;
        const int r = rest % NR, cc = rest / NR, j0 = 8 * q - 7;
        const bf16* e = reinterpret_cast<const bf16*>(&val[u]);
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8)
          if (j0 + c8 >= 0 && j0 + c8 < T_RC) put(r, j0 + c8, cc, e[c8]);
      }
    }
  } else {
    // element by element, channels fastest
    constexpr int N = NR * T_RC * T_CB;
    for (int i0 = 0; i0 < N; i0 += BATCH * NT) {
      bf16 val[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * NT + tid, cc = i % T_CB, pix = i / T_CB;
        const int r = pix / T_RC, j = pix - r * T_RC;
        val[u] = __float2bfloat16(0.f);
        if (i < N && inside(r, j)) val[u] = xb[(y0 + r) * xs.h + (x0 + j) * xs.w + cc * xs.c];
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * NT + tid, cc = i % T_CB, pix = i / T_CB;
        if (i < N) put(pix / T_RC, pix % T_RC, cc, val[u]);
      }
    }
  }
}

// V (16, p_count, c) of a chunk of the batch's tile rows: global tile row
// gr = bi * ht + tr, chunk rows g0 .. rows_end - 1, p = (gr - g0) * wt +
// tc. Block: T_TC tiles (blockIdx.x) of row g0 + rows_y (blockIdx.z / ncb)
// + blockIdx.y, channels c0 = 64 (blockIdx.z % ncb) .. c0 + 63 (a chunk of
// whole images has rows_y = ht); its 4 x 66 pixel region by `load_region`.
template <bool RELU>
__global__ void __launch_bounds__(T_THREADS)
    wino_transform_kernel(const bf16* __restrict__ x, bf16* __restrict__ v, int c, int h, int w,
                          int g0, int rows_y, int rows_end, int p_count, Strides xs, int mode) {
  __shared__ __align__(16) bf16 s_in[4 * T_RC * T_LD];
  const int tid = threadIdx.x;
  const int ht = h / 2, wt = w / 2;
  const int ncb = c / T_CB;
  const int gr = g0 + (blockIdx.z / ncb) * rows_y + blockIdx.y;
  if (gr >= rows_end) return;
  const int tc0 = blockIdx.x * T_TC, bi = gr / ht, tr = gr - bi * ht;
  const int c0 = (blockIdx.z % ncb) * T_CB;
  load_region<4, T_THREADS, T_BATCH, RELU>(s_in, x + bi * xs.b + c0 * xs.c, xs, h, w, 2 * tr - 1,
                                           tc0, mode, tid);
  __syncthreads();
  // A warp takes one tile and 32 channel pairs: each of its 16 V rows is
  // one 128-byte run.
  const int row0 = (gr - g0) * wt + tc0;
  for (int i = tid; i < T_TC * (T_CB / 2); i += T_THREADS) {
    const int cp = i % (T_CB / 2), t = i / (T_CB / 2);
    if (tc0 + t >= wt) break;
    float d0[4][4], d1[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(
            s_in + (r * T_RC + 2 * t + q) * T_LD + 2 * cp);
        d0[r][q] = __low2float(pr);
        d1[r][q] = __high2float(pr);
      }
    float o0[16], o1[16];
    bt_d_b(d0, o0);
    bt_d_b(d1, o1);
    bf16* dst = v + (size_t)(row0 + t) * c + c0 + 2 * cp;
#pragma unroll
    for (int uv = 0; uv < 16; ++uv)
      *reinterpret_cast<uint32_t*>(dst + (size_t)uv * p_count * c) = pack_bf16(o0[uv], o1[uv]);
  }
}

constexpr int G_NC = 2;                     // consumer warpgroups
constexpr int G_BM = 64;                    // tiles of a block: wgmma's M
constexpr int G_BN = 64 * G_NC;             // output channels of a block
constexpr int G_BK = 64;                    // input channels a stage: one swizzle atom
constexpr int G_STAGES = 6;
constexpr int G_VT = G_BM * G_BK;           // elements of a V tile (8 KB)
constexpr int G_UA = G_BK * 64;             // elements of one 64-column U atom (8 KB)
constexpr int G_STAGE = G_VT + G_NC * G_UA;  // a stage: V tile, then U's atoms
constexpr int G_PIX = 4 * G_BM;             // output pixels of a block
constexpr int G_SLD = G_PIX + 1;            // fp32 stride of a staged channel: odd
constexpr int G_BATCH = 16;                 // epilogue pairs in flight a thread
// Registers a thread after setmaxnreg (the register file split: 128 x 40
// + 256 x 232 <= 65536). ptxas fits each branch in its own: held to the
// 168 of 384 threads' even share, the consumers' M, its stage and four
// output accumulators spilled.
constexpr int G_PRODUCER_REGS = 40, G_CONSUMER_REGS = 232;
static_assert(G_BN * G_SLD * 4 <= G_STAGES * G_STAGE * 2, "the staged tile fits the ring");
// the ring, 2 G_STAGES + 1 mbarriers, two element offsets (out, res) a
// tile, conv2's residual tile (bf16, G_BN x G_PIX)
constexpr int G_SMEM =
    1024 + G_STAGES * G_STAGE * 2 + (2 * G_STAGES + 1) * 8 + G_BM * 16 + G_BN * G_PIX * 2;

// The epilogue of one conv, rounded once: out = relu(acc + bias) (K9b's
// conv1), acc + bias + res (K9b's conv2, res read through its strides) or
// acc + bias (K9a).
enum : int { EPI_RELU = 0, EPI_RESIDUAL = 1, EPI_BIAS = 2 };
struct GemmOut {
  const bf16* bias;
  const bf16* res;
  bf16* out;
  Strides rs, os;
  bool pairs;  // element pairs as 4-byte words (`pairs_in`, out and res)
};

// The epilogue's element pairs, adjacent in memory: pixels (b = 0, 1)
// where out's rows are W-contiguous (pix_minor), channels (kl, kl + 1)
// otherwise. Pair i of a block's G_BN x G_PIX tile, and where a pair lies
// in a bf16 tile of that shape: within a channel's row or a pixel's column.
__device__ __forceinline__ void pair_at(bool pix_minor, int i, int& kl, int& pix) {
  if (pix_minor) {
    kl = i / (G_PIX / 2);
    pix = 2 * (i - kl * (G_PIX / 2));
  } else {
    pix = i / (G_BN / 2);
    kl = 2 * (i - pix * (G_BN / 2));
  }
}
__device__ __forceinline__ int pair_index(bool pix_minor, int kl, int pix) {
  return pix_minor ? kl * G_PIX + pix : pix * G_BN + kl;
}

// out (B, H, W, K) through os = the Winograd conv of the tiles p_begin ..
// p_begin + p_count - 1 of the batch, whose V rows map_v holds ((c,
// p_count, 16), boxes of 64 x 64), with U (map_u: (k, c, 16), boxes of 64
// x 64). Block: tiles G_BM blockIdx.x / nkb .. of the chunk, output
// channels G_BN (blockIdx.x % nkb) .. (the blocks sharing V's rows run
// side by side, so the second read of a V tile mostly hits L2).
template <int EPI>
__global__ void __launch_bounds__(hopper::ws_threads(G_NC), 1)
    wino_gemm_kernel(const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_u, GemmOut g, int c, int k, int h,
                     int w, int p_begin, int p_count) {
  using namespace s3od::hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);  // [G_STAGES][G_STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G_STAGES * G_STAGE);
  uint64_t* empty = full + G_STAGES;

  const int nkb = k / G_BN;
  const int k0 = (blockIdx.x % nkb) * G_BN, p0 = (blockIdx.x / nkb) * G_BM;
  const int nck = c / G_BK;  // stages per uv

  // Past the ring and its barriers: `ready` (offs and res_s are filled),
  // each tile's element offsets of out and res, and conv2's tile of x.
  // They are found from `empty` in each branch, so that nothing more stays
  // live across the consumers' products.
  auto ready_bar = [&] { return empty + G_STAGES; };
  auto tile_offs = [&] { return reinterpret_cast<long long*>(empty + G_STAGES + 1); };
  auto res_tile = [&] { return reinterpret_cast<bf16*>(tile_offs() + 2 * G_BM); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G_NC * 128);
    }
    mbar_init(ready_bar(), 96);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<G_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < 16 * nck; ++i) {
        const int s = i % G_STAGES, ph = (i / G_STAGES) & 1;
        const int uv = i / nck, kc = (i - uv * nck) * G_BK;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], G_STAGE * 2);
        bf16* st = ring + s * G_STAGE;
        tma_load_3d(st, &map_v, &full[s], kc, p0, uv);
#pragma unroll
        for (int a = 0; a < G_NC; ++a)
          tma_load_3d(st + G_VT + a * G_UA, &map_u, &full[s], k0 + 64 * a, kc, uv);
      }
    } else if (threadIdx.x >= 32) {
      // Warps 1-3, while the products run: each tile's element offsets,
      // then (conv2) x's tile copied into res_s by cp.async, so that the
      // epilogue does not wait out device-memory latency; `ready` when done.
      const int pt = threadIdx.x - 32, ht = h / 2, wt = w / 2;
      const bool pix_minor = g.os.c != 1;
      long long* offs = tile_offs();
      bf16* res_s = res_tile();
      for (int tl = pt; tl < G_BM; tl += 96) {
        if (p0 + tl >= p_count) continue;
        const int p = p_begin + p0 + tl, bi = p / (ht * wt), rem = p - bi * (ht * wt);
        const int tr = rem / wt, tc = rem - tr * wt;
        offs[2 * tl] = bi * g.os.b + 2 * tr * g.os.h + 2 * tc * g.os.w;
        offs[2 * tl + 1] = bi * g.rs.b + 2 * tr * g.rs.h + 2 * tc * g.rs.w;
      }
      named_sync(2, 96);
      if (EPI == EPI_RESIDUAL && g.pairs) {
        for (int i = pt; i < G_BN * G_PIX / 2; i += 96) {
          int kl, pix;
          pair_at(pix_minor, i, kl, pix);
          const int tile = (pix >> 1) % G_BM, a = pix / (2 * G_BM), b = pix & 1;
          if (p0 + tile >= p_count) continue;
          const bf16* r = g.res + offs[2 * tile + 1] + a * g.rs.h + b * g.rs.w + (k0 + kl) * g.rs.c;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           smem_addr(res_s + pair_index(pix_minor, kl, pix))),
                       "l"(r));
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      }
      mbar_arrive(ready_bar());
    }
    return;
  }
  setmaxnreg_inc<G_CONSUMER_REGS>();
  const int hw = wg - 1, t = threadIdx.x - 128 * wg;
  float m[32], mk[32], y[4][32];
#pragma unroll
  for (int ab = 0; ab < 4; ++ab)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[ab][i] = 0.f;

  int step = 0;
#pragma unroll
  for (int uv = 0; uv < 16; ++uv) {
    // M = V[uv] U[uv] over the whole C reduction: each stage's 64 channels
    // in a fresh wgmma accumulator, added into M in fp32 (chained across
    // all stages, the tensor cores' accumulation sat measurably further
    // from the plain version's fp32 sums). A second accumulator, so that
    // one stage's products ran while the previous one's were added, made
    // ptxas serialise the wgmmas (C7514) and the kernel slower.
#pragma unroll
    for (int i = 0; i < 32; ++i) m[i] = 0.f;
    for (int kc = 0; kc < nck; ++kc, ++step) {
      const int s = step % G_STAGES;
      mbar_wait(&full[s], (step / G_STAGES) & 1);
      const bf16* tv = ring + s * G_STAGE;
      const bf16* tu = tv + G_VT + hw * G_UA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_BK / 16; ++kk)
        WgmmaSSBt<64>::mma(mk, desc_sw128(tv + kk * 16), desc_sw128(tu + kk * 16 * 64, G_UA * 2),
                           kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(mk);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 32; ++i) m[i] += mk[i];
    }
    // y[2a + b] += A^T[a][u] A^T[b][v] M
#pragma unroll
    for (int ab = 0; ab < 4; ++ab) {
      const int cf = at(ab >> 1, uv >> 2) * at(ab & 1, uv & 3);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (cf > 0) y[ab][i] += m[i];
        if (cf < 0) y[ab][i] -= m[i];
      }
    }
  }

  // The epilogue goes through shared memory, so that both memory orders
  // store (and conv2 reads x) in runs: acc + bias staged in fp32 by
  // channel, [G_BN][G_SLD], pixel (a G_BM + tile) 2 + b, over the ring once
  // both warpgroups' products are done with it.
  const int ct = threadIdx.x - 128;  // 0 .. 255 over both warpgroups
  float* stage = reinterpret_cast<float*>(ring);
  named_sync(1, 256);
  // Fragment: y[ab][4 j + e] is tile 16 (t / 32) + (t % 32) / 4 + 8 (e / 2)
  // and output channel 8 j + 2 (t % 4) + e % 2 of this warpgroup's 64.
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = 64 * hw + 8 * j + 2 * (t & 3) + (e & 1);
      const int row = 16 * (t >> 5) + ((t & 31) >> 2) + 8 * (e >> 1);
      const float bk = __bfloat162float(g.bias[k0 + kl]);
#pragma unroll
      for (int ab = 0; ab < 4; ++ab)
        stage[kl * G_SLD + ((ab >> 1) * G_BM + row) * 2 + (ab & 1)] = y[ab][4 * j + e] + bk;
    }
  named_sync(1, 256);
  // relu(acc + b1) (conv1) or acc + b2 + x (conv2), rounded once, a pair
  // at a time (`pair_at`), G_BATCH pairs in flight a thread where x is
  // read from device memory (strides that split the pairs).
  const bool pix_minor = g.os.c != 1;
  const long long* offs = tile_offs();
  const bf16* res_s = res_tile();
  mbar_wait(ready_bar(), 0);
  const int second = pix_minor ? 1 : G_SLD;  // the pair's second staged value
  for (int i0 = 0; i0 < G_BN * G_PIX / 2; i0 += G_BATCH * 256) {
    float v0[G_BATCH], v1[G_BATCH];
    long long dst[G_BATCH];
#pragma unroll
    for (int u = 0; u < G_BATCH; ++u) {
      int kl, pix;
      pair_at(pix_minor, i0 + u * 256 + ct, kl, pix);
      const int tile = (pix >> 1) % G_BM, a = pix / (2 * G_BM), b = pix & 1;
      const int kk = k0 + kl;
      dst[u] = -1;
      if (p0 + tile < p_count) {
        dst[u] = offs[2 * tile] + a * g.os.h + b * g.os.w + kk * g.os.c;
        v0[u] = stage[kl * G_SLD + pix];
        v1[u] = stage[kl * G_SLD + pix + second];
        if (EPI == EPI_RESIDUAL) {
          if (g.pairs) {
            const __nv_bfloat162 rr =
                *reinterpret_cast<const __nv_bfloat162*>(res_s + pair_index(pix_minor, kl, pix));
            v0[u] += __low2float(rr);
            v1[u] += __high2float(rr);
          } else {
            const bf16* r = g.res + offs[2 * tile + 1] + a * g.rs.h + b * g.rs.w + kk * g.rs.c;
            v0[u] += __bfloat162float(r[0]);
            v1[u] += __bfloat162float(r[pix_minor ? g.rs.w : g.rs.c]);
          }
        } else if (EPI == EPI_RELU) {
          v0[u] = fmaxf(v0[u], 0.f);
          v1[u] = fmaxf(v1[u], 0.f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < G_BATCH; ++u) {
      if (dst[u] < 0) continue;
      bf16* o = g.out + dst[u];
      if (g.pairs) {
        *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0[u], v1[u]);
      } else {
        o[0] = __float2bfloat16(v0[u]);
        o[pix_minor ? g.os.w : g.os.c] = __float2bfloat16(v1[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9a's fused route: the transform inside the GEMM, V never in device memory
// ---------------------------------------------------------------------------

constexpr int F_TR = 2, F_TC = T_TC;         // tiles of a block: 2 tile rows x 32
constexpr int F_NR = 2 * F_TR + 2;           // its region's pixel rows
// The region's pixel columns (66 used), TMA rows a multiple of 16 bytes:
// pixels from image column 2 tc0 - 1; channel planes from 2 tc0 - 8, since
// a box's innermost coordinate must start 16-byte aligned.
constexpr int F_RC_PIXELS = 72, F_RC_PLANES = 80;
constexpr int F_UV = 8;                       // uv of a V slot: half of a chunk's 16
constexpr int F_SLOT = F_UV * G_VT;           // elements of a V slot (64 KB)
constexpr int F_USTAGE = G_NC * G_UA;         // elements of a U stage (16 KB)
constexpr int F_USTAGES = 2;
constexpr int F_REGION = F_NR * F_RC_PLANES * G_BK;  // elements of the x region (60 KB)
constexpr int F_PRODUCERS = 2;                // producer warpgroups
constexpr int F_THREADS = 128 * (F_PRODUCERS + G_NC);
constexpr int F_TTHREADS = 128 * F_PRODUCERS - 32;  // the transform's threads: warps 1-7
// Registers a thread after setmaxnreg: 256 x 56 + 256 x 200 <= 65536 (the
// transform threads hold a patch's half, the consumers a stage's product
// and four output accumulators).
constexpr int F_PRODUCER_REGS = 56, F_CONSUMER_REGS = 200;
// two V slots, the U ring, the region, 2 + 2 + 2 F_USTAGES + 1 mbarriers
constexpr int F_SMEM =
    1024 + 2 * F_SLOT * 2 + F_USTAGES * F_USTAGE * 2 + F_REGION * 2 + (5 + 2 * F_USTAGES) * 8;
static_assert(G_BN * G_SLD * 4 <= (2 * F_SLOT + F_USTAGES * F_USTAGE) * 2,
              "the staged tile fits the V slots and the U ring");

// Half hf of one tile's V for two channels: from its patch rows hf .. hf
// + 2 (d0: channel 2 cp, d1: 2 cp + 1; [row][column]) to uv 8 hf .. 8 hf
// + 7 (the same fp32 operations as `bt_d_b`), bf16 pairs into the slot:
// row m of each uv's 64 x 64 tile, in the 128-byte swizzle.
__device__ __forceinline__ void v_half(int hf, const float (&d0)[3][4], const float (&d1)[3][4],
                                       bf16* slot, int m, int cp) {
  float t0[2][4], t1[2][4];  // t[u - 2 hf][q]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (hf == 0) {  // t[0] = d0 - d2, t[1] = d1 + d2
      t0[0][q] = d0[0][q] - d0[2][q], t1[0][q] = d1[0][q] - d1[2][q];
      t0[1][q] = d0[1][q] + d0[2][q], t1[1][q] = d1[1][q] + d1[2][q];
    } else {  // t[2] = -d1 + d2, t[3] = d1 - d3
      t0[0][q] = -d0[0][q] + d0[1][q], t1[0][q] = -d1[0][q] + d1[1][q];
      t0[1][q] = d0[0][q] - d0[2][q], t1[1][q] = d1[0][q] - d1[2][q];
    }
  }
  const int sw = ((((2 * cp) >> 3) ^ (m & 7)) << 3) | ((2 * cp) & 7);
#pragma unroll
  for (int ul = 0; ul < 2; ++ul) {
    const float o0[4] = {t0[ul][0] - t0[ul][2], t0[ul][1] + t0[ul][2], -t0[ul][1] + t0[ul][2],
                         t0[ul][1] - t0[ul][3]};
    const float o1[4] = {t1[ul][0] - t1[ul][2], t1[ul][1] + t1[ul][2], -t1[ul][1] + t1[ul][2],
                         t1[ul][1] - t1[ul][3]};
#pragma unroll
    for (int v = 0; v < 4; ++v)
      *reinterpret_cast<uint32_t*>(slot + (ul * 4 + v) * G_VT + m * G_BK + sw) =
          pack_bf16(o0[v], o1[v]);
  }
}

// out (B, H, W, K) through os = x's Winograd conv with U (map_u) + bias,
// one launch. Block: 2 x 32 tiles (tile rows 2 blockIdx.y .., columns 32
// blockIdx.x ..) of image blockIdx.z / nkb, output channels 128
// (blockIdx.z % nkb) ... Per 64-channel chunk of x, one thread loads the
// block's 6-row pixel region by TMA (map_x; zeros outside the image:
// channel planes [c][row][column] for NCHW memory, PLANES, else pixels
// [row][column][c]), and the transform threads write V in two halves (uv
// 0-7 from patch rows 0-2, uv 8-15 from rows 1-3, `v_half`) into two
// shared-memory slots, each uv a 64 x 64 tile in the 128-byte swizzle
// wgmma reads; one thread keeps U's (chunk, uv) tiles coming by TMA. The
// consumers (K9b's: two warpgroups of 64 output channels, SS wgmma
// m64n64k16) fold each (chunk, uv) product into the four output
// accumulators as it completes, so one slot fills while the other is
// read, and the next region loads while the last half is read. The
// epilogue is the GEMM's, without residual.
template <bool PLANES>
__global__ void __launch_bounds__(F_THREADS, 1)
    wino_fused_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_u, GemmOut g, int c, int k, int h,
                      int w) {
  using namespace s3od::hopper;
  constexpr int RC = PLANES ? F_RC_PLANES : F_RC_PIXELS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* vslot = reinterpret_cast<bf16*>(base);   // [2][F_UV][G_BM][G_BK], swizzled
  bf16* ustage = vslot + 2 * F_SLOT;             // [F_USTAGES][G_NC][G_BK][64]
  bf16* region = ustage + F_USTAGES * F_USTAGE;  // PLANES ? [G_BK][F_NR][RC] : [F_NR][RC][G_BK]
  uint64_t* vfull = reinterpret_cast<uint64_t*>(region + F_REGION);
  uint64_t* vempty = vfull + 2;
  uint64_t* ufull = vempty + 2;
  uint64_t* uempty = ufull + F_USTAGES;
  uint64_t* rfull = uempty + F_USTAGES;

  const int ht = h / 2, wt = w / 2, nkb = k / G_BN;
  const int bi = blockIdx.z / nkb, k0 = (blockIdx.z - bi * nkb) * G_BN;
  const int tr0 = blockIdx.y * F_TR, tc0 = blockIdx.x * F_TC;
  const int nck = c / G_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&vfull[s], F_TTHREADS);
      mbar_init(&vempty[s], G_NC * 128);
    }
    for (int s = 0; s < F_USTAGES; ++s) {
      mbar_init(&ufull[s], 1);
      mbar_init(&uempty[s], G_NC * 128);
    }
    mbar_init(rfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg < F_PRODUCERS) {
    setmaxnreg_dec<F_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < 16 * nck; ++i) {  // U in the consumers' order: chunk, then uv
        const int s = i % F_USTAGES, ph = (i / F_USTAGES) & 1;
        const int kc = i / 16, uv = i - 16 * kc;
        mbar_wait(&uempty[s], ph ^ 1);
        mbar_expect_tx(&ufull[s], F_USTAGE * 2);
#pragma unroll
        for (int a = 0; a < G_NC; ++a)
          tma_load_3d(ustage + s * F_USTAGE + a * G_UA, &map_u, &ufull[s], k0 + 64 * a, kc * G_BK,
                      uv);
      }
    } else if (threadIdx.x >= 32) {
      const int pt = threadIdx.x - 32;
      for (int kc = 0; kc < nck; ++kc) {
        if (pt == 0) {
          mbar_expect_tx(rfull, F_NR * RC * G_BK * 2);
          if (PLANES)
            tma_load_4d(region, &map_x, rfull, 2 * tc0 - 8, 2 * tr0 - 1, kc * G_BK, bi);
          else
            tma_load_4d(region, &map_x, rfull, kc * G_BK, 2 * tc0 - 1, 2 * tr0 - 1, bi);
        }
        mbar_wait(rfull, kc & 1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mbar_wait(&vempty[hf], (kc & 1) ^ 1);
          bf16* slot = vslot + hf * F_SLOT;
          for (int i = pt; i < G_BM * (G_BK / 2); i += F_TTHREADS) {
            float d0[3][4], d1[3][4];  // channels 2 cp, 2 cp + 1 of patch rows hf .. hf + 2
            int m, cp;
            if (PLANES) {
              // a warp: one tile row and channel pair, its lanes the 32 tiles
              // of the row. Patch columns 0 .. 3 are image columns 2 tc0 + 2
              // lane - 1 .., region columns 2 lane + 7 ..: the second half
              // of one aligned pair and both of the next two.
              const int lane = i & 31, rest = i >> 5, trl = rest & 1;
              cp = rest >> 1;
              m = trl * F_TC + lane;
              const bf16* s0 = region + ((2 * cp) * F_NR + 2 * trl + hf) * RC + 2 * lane + 6;
#pragma unroll
              for (int r = 0; r < 3; ++r)
#pragma unroll
                for (int ch = 0; ch < 2; ++ch) {
                  const __nv_bfloat162* pr =
                      reinterpret_cast<const __nv_bfloat162*>(s0 + ch * F_NR * RC + r * RC);
                  const float2 a = __bfloat1622float2(pr[0]), b = __bfloat1622float2(pr[1]),
                               e = __bfloat1622float2(pr[2]);
                  float(&d)[3][4] = ch ? d1 : d0;
                  d[r][0] = a.y, d[r][1] = b.x, d[r][2] = b.y, d[r][3] = e.x;
                }
            } else {
              // a warp: one tile, its lanes the 32 channel pairs
              cp = i % (G_BK / 2);
              m = i / (G_BK / 2);
              const bf16* src =
                  region + ((2 * (m / F_TC) + hf) * RC + 2 * (m % F_TC)) * G_BK + 2 * cp;
#pragma unroll
              for (int r = 0; r < 3; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float2 a = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(src + (r * RC + q) * G_BK));
                  d0[r][q] = a.x, d1[r][q] = a.y;
                }
            }
            v_half(hf, d0, d1, slot, m, cp);
          }
          fence_proxy_async();
          mbar_arrive(&vfull[hf]);
        }
        named_sync(2, F_TTHREADS);  // the region is read: the next chunk's may load
      }
    }
    return;
  }
  setmaxnreg_inc<F_CONSUMER_REGS>();
  const int hw = wg - F_PRODUCERS, t = threadIdx.x - 128 * wg;
  float mk[32], y[4][32];
#pragma unroll
  for (int ab = 0; ab < 4; ++ab)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[ab][i] = 0.f;

  int step = 0;
  for (int kc = 0; kc < nck; ++kc) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mbar_wait(&vfull[hf], kc & 1);
      const bf16* slot = vslot + hf * F_SLOT;
#pragma unroll
      for (int ul = 0; ul < F_UV; ++ul, ++step) {
        const int s = step % F_USTAGES;
        mbar_wait(&ufull[s], (step / F_USTAGES) & 1);
        const bf16* tv = slot + ul * G_VT;
        const bf16* tu = ustage + s * F_USTAGE + hw * G_UA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 16; ++kk)
          WgmmaSSBt<64>::mma(mk, desc_sw128(tv + kk * 16), desc_sw128(tu + kk * 16 * 64, G_UA * 2),
                             kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(mk);
        mbar_arrive(&uempty[s]);
        // y[2a + b] += A^T[a][u] A^T[b][v] (this chunk's V[uv] U[uv])
        const int uv = hf * F_UV + ul;
#pragma unroll
        for (int ab = 0; ab < 4; ++ab) {
          const int cf = at(ab >> 1, uv >> 2) * at(ab & 1, uv & 3);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            if (cf > 0) y[ab][i] += mk[i];
            if (cf < 0) y[ab][i] -= mk[i];
          }
        }
      }
      mbar_arrive(&vempty[hf]);
    }
  }

  // acc + bias staged in fp32 by channel ([G_BN][G_SLD], pixel (a G_BM +
  // tile) 2 + b) over the V slots and the U ring, then stored in pairs
  // along out's minor dimension, as the GEMM's epilogue does.
  const int ct = threadIdx.x - 128 * F_PRODUCERS;  // 0 .. 255 over both consumers
  float* stage = reinterpret_cast<float*>(vslot);
  named_sync(1, 256);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = 64 * hw + 8 * j + 2 * (t & 3) + (e & 1);
      const int row = 16 * (t >> 5) + ((t & 31) >> 2) + 8 * (e >> 1);
      const float bk = __bfloat162float(g.bias[k0 + kl]);
#pragma unroll
      for (int ab = 0; ab < 4; ++ab)
        stage[kl * G_SLD + ((ab >> 1) * G_BM + row) * 2 + (ab & 1)] = y[ab][4 * j + e] + bk;
    }
  named_sync(1, 256);
  const bool pix_minor = g.os.c != 1;
  const int second = pix_minor ? 1 : G_SLD;
  bf16* ob = g.out + bi * g.os.b;
  for (int i = ct; i < G_BN * G_PIX / 2; i += 256) {
    int kl, pix;
    pair_at(pix_minor, i, kl, pix);
    const int m = (pix >> 1) % G_BM, a = pix / (2 * G_BM), b = pix & 1;
    const int tr = tr0 + m / F_TC, tc = tc0 + m % F_TC;
    if (tr >= ht || tc >= wt) continue;
    const float v0 = stage[kl * G_SLD + pix], v1 = stage[kl * G_SLD + pix + second];
    bf16* o = ob + (2 * tr + a) * g.os.h + (2 * tc + b) * g.os.w + (k0 + kl) * g.os.c;
    if (g.pairs) {
      *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
    } else {
      o[0] = __float2bfloat16(v0);
      o[pix_minor ? g.os.w : g.os.c] = __float2bfloat16(v1);
    }
  }
}

// Whether the element pairs the epilogue writes (and reads of res) are
// aligned 4-byte words of (b, h, w, c) strides s from p: the minor
// dimension (w where c is not contiguous, else c) contiguous, the other
// strides even.
bool pairs_in(const void* p, const Strides& s, bool pix_minor) {
  const long long minor = pix_minor ? s.w : s.c, other = pix_minor ? s.c : s.w;
  return minor == 1 && other % 2 == 0 && s.h % 2 == 0 && s.b % 2 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

// The tensor map of a (planes, rows, cols) bf16 tensor, row-major, read in
// 64 x 64 boxes with the 128-byte swizzle.
int encode_tiles(CUtensorMap* map, const void* ptr, long long planes, long long rows,
                 long long cols) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)planes};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)(rows * cols * 2)};
  const uint32_t box[3] = {64, 64, 1};
  return hopper::encode_bf16_map(map, ptr, 3, dims, strides, box);
}

// One Winograd conv over the batch's tile rows g0 .. g0 + rows - 1 (rows
// < ht, or a multiple of ht: whole images): the transform of x (ReLU'd
// for K9b's conv1) into v, then the GEMM with U (map_u) into g.out.
template <int EPI>
int conv_rows(const bf16* x, const Strides& xs, bf16* v, const CUtensorMap& map_u,
              const GemmOut& g, int batch, int c, int k, int h, int w, int g0, int rows,
              cudaStream_t st) {
  const int ht = h / 2, wt = w / 2;
  const int rows_y = rows < ht ? rows : ht;
  const int rows_end = g0 + rows < batch * ht ? g0 + rows : batch * ht;
  const int p_count = (rows_end - g0) * wt;
  const dim3 tgrid((wt + T_TC - 1) / T_TC, rows_y, (rows + rows_y - 1) / rows_y * (c / T_CB));
  wino_transform_kernel<EPI == EPI_RELU><<<tgrid, T_THREADS, 0, st>>>(
      x, v, c, h, w, g0, rows_y, rows_end, p_count, xs, load_mode(x, w, xs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_v;
  const int e = encode_tiles(&map_v, v, 16, p_count, c);
  if (e) return e;
  err = cudaFuncSetAttribute(wino_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p_count + G_BM - 1) / G_BM * (k / G_BN);
  wino_gemm_kernel<EPI><<<blocks, hopper::ws_threads(G_NC), G_SMEM, st>>>(
      map_v, map_u, g, c, k, h, w, g0 * wt, p_count);
  return static_cast<int>(cudaGetLastError());
}

// Whether a conv of these sizes fits the launches: c a multiple of 64
// (the transform's blocks, the GEMM's stages), k of 128 (its blocks), h
// and w even, and chunks of `rows` tile rows within the grid's limits.
bool fits(int batch, int c, int h, int w, int k, int rows) {
  if (batch <= 0 || c <= 0 || c % T_CB || k <= 0 || k % G_BN || h <= 0 || w <= 0 || h % 2 ||
      w % 2 || rows <= 0)
    return false;
  const int ht = h / 2, wt = w / 2;
  if (rows > ht && rows % ht) return false;
  const int rows_y = rows < ht ? rows : ht;
  const long long chunk_tiles = (long long)rows * wt;
  return rows_y <= 65535 && (long long)(rows / rows_y) * (c / T_CB) <= 65535 &&
         (long long)batch * ht * wt <= 0x7fffffffLL && chunk_tiles * c * 16 <= (1LL << 40) &&
         (chunk_tiles + G_BM - 1) / G_BM * (k / G_BN) <= 0x7fffffffLL;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// U = G w G^T of w (3, 3, c, k) through strides ws into u (16, c, k), and
// its tensor map (boxes of 64 x 64).
int weights(const void* w, const Strides& ws, void* u, int c, int k, CUtensorMap* map_u,
            cudaStream_t st) {
  const long long n = (long long)c * k;
  wino_weights_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(u), c, k, ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return encode_tiles(map_u, u, 16, c, k);
}

// K9a's fused route: x's tensor map (channel planes for NCHW memory,
// pixels for NHWC memory; other strides are refused) and the launch.
int fused(const bf16* x, const Strides& xs, const CUtensorMap& map_u, const GemmOut& g,
          int batch, int c, int h, int w, int k, cudaStream_t st) {
  const int mode = load_mode(x, w, xs);  // its chunked modes are TMA's strides
  if (mode == BY_ELEMENT) return static_cast<int>(cudaErrorInvalidValue);
  const bool planes = mode == BY_ROW;
  CUtensorMap map_x;
  const uint64_t dims_p[4] = {(uint64_t)w, (uint64_t)h, (uint64_t)c, (uint64_t)batch};
  const uint64_t strides_p[3] = {(uint64_t)xs.h * 2, (uint64_t)xs.c * 2, (uint64_t)xs.b * 2};
  const uint32_t box_p[4] = {F_RC_PLANES, F_NR, G_BK, 1};
  const uint64_t dims_n[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)batch};
  const uint64_t strides_n[3] = {(uint64_t)xs.w * 2, (uint64_t)xs.h * 2, (uint64_t)xs.b * 2};
  const uint32_t box_n[4] = {G_BK, F_RC_PIXELS, F_NR, 1};
  const int e = planes ? hopper::encode_bf16_plain_map(&map_x, x, 4, dims_p, strides_p, box_p)
                       : hopper::encode_bf16_plain_map(&map_x, x, 4, dims_n, strides_n, box_n);
  if (e) return e;
  auto kernel = planes ? wino_fused_kernel<true> : wino_fused_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w / 2 + F_TC - 1) / F_TC, (h / 2 + F_TR - 1) / F_TR, batch * (k / G_BN));
  kernel<<<grid, F_THREADS, F_SMEM, st>>>(map_x, map_u, g, c, k, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9a. x, out: (batch, h, w, c / k) through strides (b, h, w, c); w: (3,
// 3, c, k) bf16 through strides (kernel row, kernel column, c, k); bias:
// (k,); ubuf: scratch for U (16, c, k). route 0: the batch's tile rows in
// chunks of `rows` (fewer than h / 2, or whole images), each a transform
// into vbuf (16, rows (w / 2), c) and the GEMM; route 1: one fused launch
// (vbuf unused). Scratch 16-byte aligned; c a multiple of 64, k of 128, h
// and w even (checked by the Python wrapper as well).
extern "C" int s3od_winograd_conv(const void* x, const void* w, const void* bias, void* out,
                                  void* ubuf, void* vbuf, int batch, int c, int h, int w_, int k,
                                  int rows, int route, long long wsh, long long wsw,
                                  long long wsc, long long wsk, long long xsb, long long xsh,
                                  long long xsw, long long xsc, long long osb, long long osh,
                                  long long osw, long long osc, void* stream) {
  const int ht = h / 2, wt = w_ / 2;
  if (!fits(batch, c, h, w_, k, route == 1 ? batch * ht : rows) || !aligned16(ubuf) ||
      (route == 0 && !aligned16(vbuf)) || (route == 1 && ((long long)batch * (k / G_BN) > 65535 ||
                                                          (ht + F_TR - 1) / F_TR > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap map_u;
  int e = weights(w, Strides{wsh, wsw, wsc, wsk}, ubuf, c, k, &map_u, st);
  if (e) return e;
  const Strides xs{xsb, xsh, xsw, xsc}, os{osb, osh, osw, osc};
  const GemmOut g{static_cast<const bf16*>(bias), nullptr, static_cast<bf16*>(out), os, os,
                  pairs_in(out, os, os.c != 1)};
  const bf16* xb = static_cast<const bf16*>(x);
  if (route == 1) return fused(xb, xs, map_u, g, batch, c, h, w_, k, st);
  for (int g0 = 0; g0 < batch * ht && !e; g0 += rows)
    e = conv_rows<EPI_BIAS>(xb, xs, static_cast<bf16*>(vbuf), map_u, g, batch, c, k, h, w_, g0,
                            rows, st);
  return e;
}

// K9b. x, out: (batch, h, w, c) through strides; w1, w2: (3, 3, c, c) bf16
// through strides; b1, b2: (c,); ubuf: (2, 16, c, c) scratch for U1, U2;
// hbuf: (batch, h, w, c) NHWC scratch for the intermediate; vbuf: (16,
// batch (h / 2) (w / 2), c) scratch for V, all 16-byte aligned. h and w
// even, c a multiple of 128 (checked by the Python wrapper as well).
extern "C" int s3od_winograd_rcu(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* ubuf, void* hbuf, void* vbuf, void* out,
                                 int batch, int c, int h, int w, long long w1h, long long w1w,
                                 long long w1c, long long w1k, long long w2h, long long w2w,
                                 long long w2c, long long w2k, long long xsb, long long xsh,
                                 long long xsw, long long xsc, long long osb, long long osh,
                                 long long osw, long long osc, void* stream) {
  const int rows = batch * (h / 2);  // one chunk: the whole batch
  if (c % G_BN || !fits(batch, c, h, w, c, rows) || !aligned16(ubuf) || !aligned16(hbuf) ||
      !aligned16(vbuf))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap map_u1, map_u2;
  bf16* u1 = static_cast<bf16*>(ubuf);
  int e = weights(w1, Strides{w1h, w1w, w1c, w1k}, u1, c, c, &map_u1, st);
  if (!e) e = weights(w2, Strides{w2h, w2w, w2c, w2k}, u1 + (size_t)16 * c * c, c, c, &map_u2, st);
  if (e) return e;
  const Strides xs{xsb, xsh, xsw, xsc}, os{osb, osh, osw, osc};
  const Strides hs{(long long)h * w * c, (long long)w * c, c, 1};
  bf16* hb = static_cast<bf16*>(hbuf);
  bf16* vb = static_cast<bf16*>(vbuf);
  const bf16* xb = static_cast<const bf16*>(x);
  // conv1: V of relu(x), then h = relu(acc + b1)
  const GemmOut g1{static_cast<const bf16*>(b1), nullptr, hb, hs, hs,
                   pairs_in(hb, hs, false)};
  e = conv_rows<EPI_RELU>(xb, xs, vb, map_u1, g1, batch, c, c, h, w, 0, rows, st);
  if (e) return e;
  // conv2: V of h, then out = acc + b2 + x
  const bool pix_minor = os.c != 1;
  const GemmOut g2{static_cast<const bf16*>(b2), xb, static_cast<bf16*>(out), xs, os,
                   pairs_in(out, os, pix_minor) && pairs_in(x, xs, pix_minor)};
  return conv_rows<EPI_RESIDUAL>(hb, hs, vb, map_u2, g2, batch, c, c, h, w, 0, rows, st);
}
