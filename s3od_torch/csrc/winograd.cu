// K9a: the Winograd F(2x2, 3x3) 3x3/stride-1/pad-1 conv + bias, and K9b:
// the chained BN-folded ResidualConvUnit x + conv2(relu(conv1(relu(x)) +
// b1)) + b2, both convs C -> C.
//
// Replace the TPU kernels `s3od_tpu/ops/experimental/winograd.py:_kernel`
// (via `conv3x3_winograd`) and `:_rcu_kernel` (via `rcu_winograd`). x and
// out are (B, H, W, C) in NHWC *logical* order with any strides (the DPT
// decoder passes NCHW memory; W-contiguous rows load coalesced); U = G w
// G^T is (16, C, K) bf16, transformed and rounded by the Python wrapper.
// Per 2x2 output tile:
//   V   = bf16(B^T d B)            d the 4x4 input patch, fp32 add/sub
//   M   = V[uv] @ U[uv]            16 products, fp32 accumulation
//   acc += A^T M A                 folded into 4 fp32 accumulators
//   out = bf16(acc + bias)         one rounding (K9b: + b2 + x, one rounding)
// — the TPU kernels' rounding points. The fold is linear, so where it runs
// (K9a: per 16-channel chunk of M; K9b: once per M, after its whole C
// reduction) changes only the fp32 order of the sums.
//
// What bounds them on the H100: F(2,3) needs 16 C K multiplies per tile
// where a direct 3x3 needs 36, so at the decoder's shapes (e.g. 256^2,
// 256 -> 256: 3.4e10 FLOP, 67 MB) the tensor-core bound (~0.035 ms) is
// above the bytes bound (~0.020 ms).
//
// K9a (this file's first kernel): warp-level mma.sync; the input transform
// and the per-chunk fold are scalar fp32 work of the same order as the
// products. No space-to-depth: the TPU version copied x into a 2x2-phase
// layout (and back) around each call so that every Mosaic slice was
// stride-1 and lane-aligned; here a block reads its halo region straight
// from x. Read element by element, every thread waits out one load latency
// per element of it, serially; so a block copies it with cp.async in
// 16-byte chunks — of one channel's row when x is NCHW memory, of 8
// channels of one pixel when it is NHWC memory (as the decoder's batch-16
// tensors are; the transform then reads it through strides) — and issues
// chunk i+1's copy before chunk i's products. Other strides take the
// element path. A block: 64 tiles (2 tile rows x 32 tile cols = 4 x 64
// outputs) x 64 output channels, 8 warps (4 along tiles x 2 along
// channels, 16 x 32 each: 64 fp32 accumulators a thread), at most 128
// registers so that two blocks share an SM. Per 16-channel chunk: the
// input region and U's chunk (cp.async) to shared memory, V to shared
// memory in bf16, then 16 x 4 mma.sync per warp and the fold. 103 KB of
// shared memory.
//
// K9b: four launches, two of them one Winograd GEMM on TMA + wgmma.
// The TPU kernel kept a full-width row block and its whole intermediate in
// 16 MB of VMEM; 227 KB of shared memory holds C = 256 channels of only a
// few dozen intermediate pixels, so a fused kernel recomputed conv1 on a
// halo 2.3x conv2's tiles and ran conv1's transform once per output block.
// Here the intermediate h = bf16(relu(conv1 + b1)) goes to device memory
// (NHWC, 33.5 MB at 256^2 x 256: it is rounded once either way, and conv2
// pads it with zeros either way), and each conv is
//   1. the input transform: V (16, P, C) bf16, P = B (H/2) (W/2) tiles, a
//      row per tile and the channels contiguous: a block stages a 4 x 66
//      pixel x 64 channel region in shared memory (ReLU'd for conv1, zero
//      outside the image) and writes 32 tiles' 16 V rows in 128-byte runs;
//   2. the GEMM: a block owns 64 tiles x 128 output channels. One
//      producer thread loads, per (uv, 64-channel chunk), V's 64 x 64 tile
//      (K-major) and U's 64 x 128 tile (MN-major, as stored) by TMA into a
//      6-stage ring; two consumer warpgroups (64 output channels each)
//      run M = V U by SS wgmma m64n64k16 over the whole C reduction of one
//      uv, each 64-channel stage in a fresh accumulator added into M in
//      fp32, then fold M into the four output accumulators with A^T's
//      signs (compile-time, so 2.25 adds per M element on average): 192
//      fp32 accumulators a thread, in 232 registers after setmaxnreg. The epilogue
//      stages acc + bias in fp32 over the ring and stores element pairs in
//      runs of the output's memory order (conv1: ReLU, into h; conv2: + x,
//      whose tile the producer warpgroup's other warps copy into shared
//      memory by cp.async while the products run).
// Why V goes through device memory: a block cannot own all K output
// channels (5 accumulators of 64 x K fp32 exceed the register file at K =
// 256), so a transform inside the GEMM would run K / 128 times and, done
// one uv at a time (4 shared loads a value), costs as much as the
// products. V is 4x the input's bytes (134 MB at 256^2 x 256, written
// once and read K / 128 = 2 times, the second mostly from L2).
#include "hopper.cuh"

using namespace s3od;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int CC = 16;       // input channels per chunk: one k16 step
constexpr int KB = 64;       // output channels per GEMM block
constexpr int LDV = CC + 8;  // bf16 row stride of V: [16][tiles][LDV]
constexpr int LDU = KB + 8;  // bf16 row stride of a U chunk: [16][CC][LDU]

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

// V of one 4x4 patch (element (r, s) at src[r * rs + s * cs], ReLU'd first
// if asked); the 16 values, rounded to bf16, go to dst[uv * dstride].
template <bool RELU>
__device__ __forceinline__ void transform_patch(const bf16* src, int rs, int cs, bf16* dst,
                                                int dstride) {
  float d[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      d[r][s] = __bfloat162float(src[r * rs + s * cs]);
      if (RELU) d[r][s] = fmaxf(d[r][s], 0.f);
    }
  float o[16];
  bt_d_b(d, o);
#pragma unroll
  for (int uv = 0; uv < 16; ++uv) dst[uv * dstride] = __float2bfloat16(o[uv]);
}

// 16-byte global -> shared copy that fills zeros when `bytes` is 0.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

// How a block reads its region of x: element by element (any strides), in
// 16-byte row chunks of one channel (NCHW memory), or in 16-byte chunks of
// 8 channels of one pixel (NHWC memory).
enum : int { BY_ELEMENT = 0, BY_ROW = 1, BY_PIXEL = 2 };

int load_mode(const void* x, int w, const Strides& xs) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs.h % 8 == 0 && xs.b % 8 == 0;
  if (aligned && xs.w == 1 && w % 8 == 0 && xs.c % 8 == 0) return BY_ROW;
  if (aligned && xs.c == 1 && xs.w % 8 == 0) return BY_PIXEL;
  return BY_ELEMENT;
}

// A region of CC channels (c0..), NR rows (from image row y0) and the
// columns x0..x0+NCOL-1, zero outside the image. BY_ELEMENT and BY_ROW keep
// channel planes, dst[cc * RS + r * RW + j] with column j <-> image column
// x0 & ~7 + j (whole 16-byte chunks for BY_ROW); BY_PIXEL keeps channels
// minor, dst[(r * RW + j) * CCP + cc] with j <-> x0 + j. The chunked modes
// copy with cp.async (the caller commits and waits); BY_ELEMENT at once.
template <int NR, int NCOL, int MODE>
struct Region {
  static constexpr int NCH = (7 + NCOL + 7) / 8;  // BY_ROW: 16-byte chunks a row
  static constexpr int PLANE_RW = NCH * 8, PLANE_RS = NR * PLANE_RW + 8;  // +8: banks
  static constexpr int CCP = CC + 8;              // BY_PIXEL: a pixel's stride
  static constexpr int RW = MODE == BY_PIXEL ? NCOL : PLANE_RW;
  static constexpr int RS = PLANE_RS;
  static constexpr int ROW = MODE == BY_PIXEL ? RW * CCP : RW;  // a patch's strides
  static constexpr int COL = MODE == BY_PIXEL ? CCP : 1;
  static constexpr int MAX_SIZE =
      CC * PLANE_RS > NR * NCOL * CCP ? CC * PLANE_RS : NR * NCOL * CCP;

  __device__ __forceinline__ static int origin(int x0) {
    return MODE == BY_PIXEL ? x0 : (x0 & ~7);
  }
  __device__ __forceinline__ static const bf16* at(const bf16* s, int cc, int r, int j) {
    return MODE == BY_PIXEL ? s + (r * RW + j) * CCP + cc : s + cc * RS + r * RW + j;
  }

  __device__ __forceinline__ static void load(bf16* dst, const bf16* xb, const Strides& xs,
                                              int h, int w, int y0, int x0, int c0, int tid) {
    const int xa = origin(x0);
    if (MODE == BY_ROW) {
      for (int i = tid; i < CC * NR * NCH; i += THREADS) {
        const int cc = i / (NR * NCH), rem = i - cc * (NR * NCH);
        const int r = rem / NCH, q = rem - r * NCH;
        const int gy = y0 + r, gx = xa + q * 8;
        const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
        const bf16* src = in ? xb + gy * xs.h + gx + (c0 + cc) * xs.c : xb;
        cp_async16_zfill(dst + cc * RS + r * RW + q * 8, src, in ? 16 : 0);
      }
    } else if (MODE == BY_PIXEL) {
      for (int i = tid; i < NR * NCOL * (CC / 8); i += THREADS) {
        const int half = i % (CC / 8), pix = i / (CC / 8);
        const int r = pix / NCOL, j = pix - r * NCOL;
        const int gy = y0 + r, gx = x0 + j;
        const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
        const bf16* src = in ? xb + gy * xs.h + gx * xs.w + c0 + half * 8 : xb;
        cp_async16_zfill(dst + (r * RW + j) * CCP + half * 8, src, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < CC * NR * NCOL; i += THREADS) {
        const int cc = i / (NR * NCOL), rem = i - cc * (NR * NCOL);
        const int r = rem / NCOL, j = rem - r * NCOL;
        const int gy = y0 + r, gx = x0 + j;
        bf16 v = __float2bfloat16(0.f);
        if (gy >= 0 && gy < h && gx >= 0 && gx < w)
          v = xb[gy * xs.h + gx * xs.w + (c0 + cc) * xs.c];
        dst[cc * RS + r * RW + gx - xa] = v;
      }
    }
  }
};

// One 16-channel chunk of U (rows uv * CC + cc, columns k0..k0+63) to
// shared memory, asynchronously.
__device__ __forceinline__ void load_u_chunk(bf16* s_u, const bf16* u, int c0, int c, int k,
                                             int k0, int tid) {
  for (int i = tid; i < 16 * CC * (KB / 8); i += THREADS) {
    const int seg = i & 7, row = i >> 3;
    const int uv = row / CC, cc = row - uv * CC;
    cp_async16(s_u + row * LDU + seg * 8, u + ((size_t)uv * c + c0 + cc) * k + k0 + seg * 8);
  }
}

// acc[2a + b] += A^T[a][u] A^T[b][v] (V[uv] @ U[uv]) over one chunk, for
// the warp's 16 tiles (rows p0.. of V, laid out [16][TP][LDV]) and NT n8
// tiles of output channels (columns k0.. of the U chunk).
template <int TP, int NT>
__device__ __forceinline__ void gemm_fold(const bf16* s_v, const bf16* s_u, int p0, int k0,
                                          int lane, float (&acc)[4][NT][4]) {
#pragma unroll
  for (int uv = 0; uv < 16; ++uv) {
    uint32_t a[4];
    load_a_frag(a, s_v + (uv * TP + p0) * LDV, LDV, lane);
    float m[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) m[n][0] = m[n][1] = m[n][2] = m[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_frag_kn(b, s_u + uv * CC * LDU + k0 + np * 16, LDU, lane);
      mma_bf16(m[2 * np], a, b[0], b[1]);
      mma_bf16(m[2 * np + 1], a, b[2], b[3]);
    }
#pragma unroll
    for (int ab = 0; ab < 4; ++ab) {
      const int cf = at(ab >> 1, uv >> 2) * at(ab & 1, uv & 3);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cf > 0) acc[ab][n][j] += m[n][j];
          if (cf < 0) acc[ab][n][j] -= m[n][j];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// K9a
// ---------------------------------------------------------------------------

constexpr int TR = 2, TC = 32, TP = TR * TC;     // tiles of a block
constexpr int IR = 2 * TR + 2, IC = 2 * TC + 2;  // its input region
template <int MODE>
using ConvRegion = Region<IR, IC, MODE>;
constexpr size_t CONV_SMEM =
    sizeof(bf16) * ((size_t)ConvRegion<BY_ROW>::MAX_SIZE + 16 * TP * LDV + 16 * CC * LDU);

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
    wino_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                     const bf16* __restrict__ bias, bf16* __restrict__ out, int c, int h, int w,
                     int k, Strides xs, Strides os) {
  using R = ConvRegion<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);  // the region, R's layout
  bf16* s_v = s_in + R::MAX_SIZE;               // [16][TP][LDV]
  bf16* s_u = s_v + 16 * TP * LDV;              // [16][CC][LDU]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ht = h / 2, wt = w / 2;
  const int tr0 = blockIdx.y * TR, tc0 = blockIdx.x * TC;
  const int nkb = k / KB;
  const int bi = blockIdx.z / nkb, k0 = (blockIdx.z - bi * nkb) * KB;
  const bf16* xb = x + bi * xs.b;
  const int y0 = 2 * tr0 - 1, x0 = 2 * tc0 - 1, xoff = x0 - R::origin(x0);
  const int p0 = (warp & 3) * 16, wk = (warp >> 2) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int ab = 0; ab < 4; ++ab)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ab][n][j] = 0.f;

  // Chunk i's region loads while chunk i-1's products run, its U chunk
  // while chunk i's transform waits on the barrier.
  const int nc = c / CC;
  R::load(s_in, xb, xs, h, w, y0, x0, 0, tid);
  load_u_chunk(s_u, u, 0, c, k, k0, tid);
  cp_async_commit();
  for (int ci = 0; ci < nc; ++ci) {
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < TP * CC; i += THREADS) {
      const int cc = i % CC, p = i / CC;
      const int pr = p / TC, pc = p - pr * TC;
      transform_patch<false>(R::at(s_in, cc, 2 * pr, xoff + 2 * pc), R::ROW, R::COL,
                             s_v + p * LDV + cc, TP * LDV);
    }
    __syncthreads();
    if (ci + 1 < nc) R::load(s_in, xb, xs, h, w, y0, x0, (ci + 1) * CC, tid);
    cp_async_commit();
    gemm_fold<TP, 4>(s_v, s_u, p0, wk, lane, acc);
    __syncthreads();
    if (ci + 1 < nc) load_u_chunk(s_u, u, (ci + 1) * CC, c, k, k0, tid);
    cp_async_commit();
  }

  bf16* ob = out + bi * os.b;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + g + (j >> 1) * 8;
      const int kk = k0 + wk + n * 8 + 2 * t + (j & 1);
      const int tr = tr0 + p / TC, tc = tc0 + p % TC;
      if (tr < ht && tc < wt) {
        const float bk = __bfloat162float(bias[kk]);
#pragma unroll
        for (int ab = 0; ab < 4; ++ab) {
          const int yy = 2 * tr + (ab >> 1), xx = 2 * tc + (ab & 1);
          ob[yy * os.h + xx * os.w + kk * os.c] = __float2bfloat16(acc[ab][n][j] + bk);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// K9b: the input transform and the Winograd GEMM, two launches each
// ---------------------------------------------------------------------------

constexpr int T_TC = 32;              // transform: tiles of a block (one tile row)
constexpr int T_CB = 64;              // transform: channels of a block
constexpr int T_RC = 2 * T_TC + 2;    // its region's pixel columns
constexpr int T_LD = T_CB + 2;        // bf16 stride of a region pixel: 33 words, odd
constexpr int T_THREADS = 256;
constexpr int T_BATCH = 8;  // loads in flight a thread

// V (16, p_total, c) of the tiles (bi, tr, T_TC blockIdx.x ..) and the
// channels c0 .. c0 + 63: p = (bi * ht + tr) * wt + tc. The region loads
// (`mode`, as K9a's `load_mode`) in 16-byte chunks of 8 channels of a
// pixel (NHWC memory) or of 8 pixels of a channel's row (NCHW memory), or
// element by element; the pixel stride of 33 words spreads the
// shared-memory stores over the banks.
template <bool RELU>
__global__ void __launch_bounds__(T_THREADS)
    wino_transform_kernel(const bf16* __restrict__ x, bf16* __restrict__ v, int c, int h, int w,
                          int p_total, Strides xs, int mode) {
  __shared__ __align__(16) bf16 s_in[4 * T_RC * T_LD];
  const int tid = threadIdx.x;
  const int ht = h / 2, wt = w / 2;
  const int tc0 = blockIdx.x * T_TC, tr = blockIdx.y;
  const int ncb = c / T_CB;
  const int bi = blockIdx.z / ncb, c0 = (blockIdx.z - bi * ncb) * T_CB;
  const bf16* xb = x + bi * xs.b + c0 * xs.c;
  const int y0 = 2 * tr - 1, x0 = 2 * tc0 - 1;
  auto put = [&](int r, int j, int cc, bf16 val) {  // region element, ReLU'd for conv1
    if (RELU) val = __float2bfloat16(fmaxf(__bfloat162float(val), 0.f));
    s_in[(r * T_RC + j) * T_LD + cc] = val;
  };
  auto inside = [&](int r, int j) {
    const int gy = y0 + r, gx = x0 + j;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  };
  if (mode == BY_PIXEL) {
    // 16-byte chunks of 8 channels of one pixel (NHWC memory)
    constexpr int N = 4 * T_RC * (T_CB / 8);
    for (int i0 = 0; i0 < N; i0 += T_BATCH * T_THREADS) {
      uint4 val[T_BATCH];
#pragma unroll
      for (int u = 0; u < T_BATCH; ++u) {
        const int i = i0 + u * T_THREADS + tid, q = i % (T_CB / 8), pix = i / (T_CB / 8);
        const int r = pix / T_RC, j = pix - r * T_RC;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < N && inside(r, j))
          val[u] = *reinterpret_cast<const uint4*>(xb + (y0 + r) * xs.h + (x0 + j) * xs.w + 8 * q);
      }
#pragma unroll
      for (int u = 0; u < T_BATCH; ++u) {
        const int i = i0 + u * T_THREADS + tid, q = i % (T_CB / 8), pix = i / (T_CB / 8);
        if (i >= N) continue;
        const bf16* e = reinterpret_cast<const bf16*>(&val[u]);
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) put(pix / T_RC, pix % T_RC, 8 * q + c8, e[c8]);
      }
    }
  } else if (mode == BY_ROW) {
    // 16-byte chunks of 8 pixels of one channel's row (NCHW memory), from
    // column 2 tc0 - 8 (a multiple of 8): region columns -7 .. 72, of
    // which 0 .. T_RC - 1 are kept; w is a multiple of 8, so a chunk lies
    // wholly inside or outside the image
    constexpr int NQ = (T_RC + 7 + 7) / 8, N = 4 * NQ * T_CB;
    for (int i0 = 0; i0 < N; i0 += T_BATCH * T_THREADS) {
      uint4 val[T_BATCH];
#pragma unroll
      for (int u = 0; u < T_BATCH; ++u) {
        const int i = i0 + u * T_THREADS + tid, q = i % NQ, rest = i / NQ;
        const int r = rest & 3, cc = rest >> 2;
        const int gy = y0 + r, gx = 2 * tc0 - 8 + 8 * q;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < N && gy >= 0 && gy < h && gx >= 0 && gx < w)
          val[u] = *reinterpret_cast<const uint4*>(xb + gy * xs.h + gx + cc * xs.c);
      }
#pragma unroll
      for (int u = 0; u < T_BATCH; ++u) {
        const int i = i0 + u * T_THREADS + tid, q = i % NQ, rest = i / NQ;
        if (i >= N) continue;
        const int r = rest & 3, cc = rest >> 2, j0 = 8 * q - 7;
        const bf16* e = reinterpret_cast<const bf16*>(&val[u]);
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8)
          if (j0 + c8 >= 0 && j0 + c8 < T_RC) put(r, j0 + c8, cc, e[c8]);
      }
    }
  } else {
    // element by element, channels fastest
    constexpr int N = 4 * T_RC * T_CB;
    for (int i0 = 0; i0 < N; i0 += T_BATCH * T_THREADS) {
      bf16 val[T_BATCH];
#pragma unroll
      for (int u = 0; u < T_BATCH; ++u) {
        const int i = i0 + u * T_THREADS + tid, cc = i % T_CB, pix = i / T_CB;
        const int r = pix / T_RC, j = pix - r * T_RC;
        val[u] = __float2bfloat16(0.f);
        if (i < N && inside(r, j)) val[u] = xb[(y0 + r) * xs.h + (x0 + j) * xs.w + cc * xs.c];
      }
#pragma unroll
      for (int u = 0; u < T_BATCH; ++u) {
        const int i = i0 + u * T_THREADS + tid, cc = i % T_CB, pix = i / T_CB;
        if (i < N) put(pix / T_RC, pix % T_RC, cc, val[u]);
      }
    }
  }
  __syncthreads();
  // A warp takes one tile and 32 channel pairs: each of its 16 V rows is
  // one 128-byte run.
  const int row0 = (bi * ht + tr) * wt + tc0;
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
      *reinterpret_cast<uint32_t*>(dst + (size_t)uv * p_total * c) = pack_bf16(o0[uv], o1[uv]);
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

// The epilogue of one conv: out = relu(acc + bias) (conv1) or acc + bias
// + res (conv2, res read through its strides), rounded once.
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

// out (B, H, W, K) through os = the Winograd conv of the tiles whose V
// rows map_v holds ((c, p_total, 16), boxes of 64 x 64) with U (map_u:
// (k, c, 16), boxes of 64 x 64). Block: tiles G_BM blockIdx.x / nkb ..,
// output channels G_BN (blockIdx.x % nkb) .. (the blocks sharing V's rows
// run side by side, so the second read of a V tile mostly hits L2).
template <bool CONV2>
__global__ void __launch_bounds__(hopper::ws_threads(G_NC), 1)
    wino_gemm_kernel(const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_u, GemmOut g, int c, int k, int h,
                     int w, int p_total) {
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
        if (p0 + tl >= p_total) continue;
        const int p = p0 + tl, bi = p / (ht * wt), rem = p - bi * (ht * wt);
        const int tr = rem / wt, tc = rem - tr * wt;
        offs[2 * tl] = bi * g.os.b + 2 * tr * g.os.h + 2 * tc * g.os.w;
        offs[2 * tl + 1] = bi * g.rs.b + 2 * tr * g.rs.h + 2 * tc * g.rs.w;
      }
      named_sync(2, 96);
      if (CONV2 && g.pairs) {
        for (int i = pt; i < G_BN * G_PIX / 2; i += 96) {
          int kl, pix;
          pair_at(pix_minor, i, kl, pix);
          const int tile = (pix >> 1) % G_BM, a = pix / (2 * G_BM), b = pix & 1;
          if (p0 + tile >= p_total) continue;
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
      if (p0 + tile < p_total) {
        dst[u] = offs[2 * tile] + a * g.os.h + b * g.os.w + kk * g.os.c;
        v0[u] = stage[kl * G_SLD + pix];
        v1[u] = stage[kl * G_SLD + pix + second];
        if (CONV2) {
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
        } else {
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

// One conv of K9b: the transform of x into v, then the GEMM into g.out.
template <bool CONV2>
int rcu_conv(const bf16* x, const Strides& xs, const CUtensorMap& map_v, const void* u,
             bf16* v, const GemmOut& g, int batch, int c, int h, int w, cudaStream_t st) {
  const int p_total = batch * (h / 2) * (w / 2);
  const dim3 tgrid((w / 2 + T_TC - 1) / T_TC, h / 2, batch * (c / T_CB));
  wino_transform_kernel<!CONV2><<<tgrid, T_THREADS, 0, st>>>(x, v, c, h, w, p_total, xs,
                                                              load_mode(x, w, xs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_u;
  const int e = encode_tiles(&map_u, u, 16, c, c);
  if (e) return e;
  err = cudaFuncSetAttribute(wino_gemm_kernel<CONV2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p_total + G_BM - 1) / G_BM * (c / G_BN);
  wino_gemm_kernel<CONV2><<<blocks, hopper::ws_threads(G_NC), G_SMEM, st>>>(map_v, map_u, g, c,
                                                                           c, h, w, p_total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (batch, h, w, c / k) through strides (b, h, w, c); u: (16, c, k);
// bias: (k,). h and w even, c a multiple of 16, k of 64 (checked by the
// Python wrapper as well).
extern "C" int s3od_winograd_conv(const void* x, const void* u, const void* bias, void* out,
                                  int batch, int c, int h, int w, int k, long long xsb,
                                  long long xsh, long long xsw, long long xsc, long long osb,
                                  long long osh, long long osw, long long osc, void* stream) {
  if (batch <= 0 || c <= 0 || c % CC || k <= 0 || k % KB || h <= 0 || w <= 0 || h % 2 || w % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w / 2 + TC - 1) / TC, (h / 2 + TR - 1) / TR, batch * (k / KB));
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xsb, xsh, xsw, xsc}, os{osb, osh, osw, osc};
  const int mode = load_mode(x, w, xs);
  auto kernel = mode == BY_ROW     ? wino_conv_kernel<BY_ROW>
                : mode == BY_PIXEL ? wino_conv_kernel<BY_PIXEL>
                                   : wino_conv_kernel<BY_ELEMENT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(CONV_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, CONV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), c, h, w, k, xs, os);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (batch, h, w, c) through strides; u1, u2: (16, c, c); b1, b2:
// (c,); hbuf: (batch, h, w, c) NHWC scratch for the intermediate; vbuf:
// (16, batch (h / 2) (w / 2), c) scratch for V, both 16-byte aligned. h
// and w even, c a multiple of 128 (checked by the Python wrapper as well).
extern "C" int s3od_winograd_rcu(const void* x, const void* u1, const void* b1, const void* u2,
                                 const void* b2, void* hbuf, void* vbuf, void* out, int batch,
                                 int c, int h, int w, long long xsb, long long xsh, long long xsw,
                                 long long xsc, long long osb, long long osh, long long osw,
                                 long long osc, void* stream) {
  if (batch <= 0 || c <= 0 || c % G_BN || h <= 0 || w <= 0 || h % 2 || w % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long p_total = (long long)batch * (h / 2) * (w / 2);
  if (h / 2 > 65535 || (long long)batch * (c / T_CB) > 65535 ||
      (p_total + G_BM - 1) / G_BM * (c / G_BN) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(hbuf) % 16 || reinterpret_cast<uintptr_t>(vbuf) % 16 ||
      reinterpret_cast<uintptr_t>(u1) % 16 || reinterpret_cast<uintptr_t>(u2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap map_v;
  int e = encode_tiles(&map_v, vbuf, 16, p_total, c);
  if (e) return e;
  const Strides xs{xsb, xsh, xsw, xsc}, os{osb, osh, osw, osc};
  const Strides hs{(long long)h * w * c, (long long)w * c, c, 1};
  bf16* hb = static_cast<bf16*>(hbuf);
  bf16* vb = static_cast<bf16*>(vbuf);
  const bf16* xb = static_cast<const bf16*>(x);
  // conv1: V of relu(x), then h = relu(acc + b1)
  const GemmOut g1{static_cast<const bf16*>(b1), nullptr, hb, hs, hs,
                   pairs_in(hb, hs, false)};
  e = rcu_conv<false>(xb, xs, map_v, u1, vb, g1, batch, c, h, w, st);
  if (e) return e;
  // conv2: V of h, then out = acc + b2 + x
  const bool pix_minor = os.c != 1;
  const GemmOut g2{static_cast<const bf16*>(b2), xb, static_cast<bf16*>(out), xs, os,
                   pairs_in(out, os, pix_minor) && pairs_in(x, xs, pix_minor)};
  return rcu_conv<true>(hb, hs, map_v, u2, vb, g2, batch, c, h, w, st);
}
