// K9a: the Winograd F(2x2, 3x3) 3x3/stride-1/pad-1 conv + bias, and K9b:
// the chained BN-folded ResidualConvUnit x + conv2(relu(conv1(relu(x)) +
// b1)) + b2, both convs C -> C, with the intermediate kept on chip.
//
// Replace the TPU kernels `s3od_tpu/ops/experimental/winograd.py:_kernel`
// (via `conv3x3_winograd`) and `:_rcu_kernel` (via `rcu_winograd`). x and
// out are (B, H, W, C) in NHWC *logical* order with any strides (the DPT
// decoder passes NCHW memory; W-contiguous rows load coalesced); U = G w
// G^T is (16, C, K) bf16, transformed and rounded by the Python wrapper.
// Per 2x2 output tile and channel chunk:
//   V   = bf16(B^T d B)            d the 4x4 input patch, fp32 add/sub
//   M   = V[uv] @ U[uv]            16 products, fp32 accumulation (mma.sync)
//   acc += A^T M A                 folded at once into 4 fp32 accumulators
//   out = bf16(acc + bias)         one rounding (K9b: + b2 + x, one rounding)
// — the TPU kernels' rounding points. The fold is linear, so it runs per
// 16-channel chunk of M; only the fp32 order of the sums differs.
//
// What bounds them on the H100: F(2,3) needs 16 C K multiplies per tile
// where a direct 3x3 needs 36, so at the decoder's shapes (e.g. 256^2,
// 256 -> 256: 3.4e10 FLOP, 67 MB) the tensor-core bound (~0.035 ms) is
// above the bytes bound (~0.020 ms). This version is well above both: the
// input transform and the per-chunk fold are scalar fp32 work of the same
// order as the products, on warp-level mma.sync.
//
// No space-to-depth: the TPU version copied x into a 2x2-phase layout
// (and back) around each call so that every Mosaic slice was stride-1 and
// lane-aligned; here a block reads its halo region straight from x. Read
// element by element, every thread waits out one load latency per element
// of it, serially; so a block copies it with cp.async in 16-byte
// chunks — of one channel's row when x is NCHW memory, of 8 channels of
// one pixel when it is NHWC memory (as the decoder's batch-16 tensors are;
// the transform then reads it through strides) — and issues chunk i+1's
// copy before chunk i's products. Other strides take the element path.
//
// K9a block: 64 tiles (2 tile rows x 32 tile cols = 4 x 64 outputs) x 64
// output channels, 8 warps (4 along tiles x 2 along channels, 16 x 32
// each: 64 fp32 accumulators a thread), at most 128 registers so that two
// blocks share an SM. Per 16-channel chunk: the input region and U's chunk
// (cp.async) to shared memory, V to shared memory in bf16, then 16 x 4
// mma.sync per warp and the fold. 103 KB of shared memory.
//
// K9b block: conv2's 2 x 14 output tiles (4 x 28 pixels), all C channels.
// The TPU kernel kept a full-width row block and its whole intermediate
// in 16 MB of VMEM; 227 KB of shared memory holds C = 256 channels of only
// 6 x 36 intermediate pixels, so the block is narrow and recomputes conv1
// on a 4 x 16 tile halo (2.3x conv2's 28 tiles; the TPU kernel's halo was
// one tile row each side), and conv1's input transform runs once for each
// of the C / 64 output blocks. Conv1's output rows and columns outside the
// image are written as zero — not relu(b1) — as the TPU kernel's zeroed
// scratch leaves them, since conv2 pads with zeros. 211 KB of shared
// memory at C = 256, one block an SM.
#include "mma.cuh"

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

// V = B^T d B of one 4x4 patch (element (r, s) at src[r * rs + s * cs],
// ReLU'd first if asked), fp32, in the TPU kernel's order of additions; the
// 16 values, rounded to bf16, go to dst[uv * dstride].
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
    dst[(u * 4 + 0) * dstride] = __float2bfloat16(t[u][0] - t[u][2]);
    dst[(u * 4 + 1) * dstride] = __float2bfloat16(t[u][1] + t[u][2]);
    dst[(u * 4 + 2) * dstride] = __float2bfloat16(-t[u][1] + t[u][2]);
    dst[(u * 4 + 3) * dstride] = __float2bfloat16(t[u][1] - t[u][3]);
  }
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
// K9b
// ---------------------------------------------------------------------------

constexpr int R_TR = 2, R_TC = 14;  // conv2 output tiles of a block (useful)
constexpr int R_P1 = 64;            // conv1 tiles: 4 tile rows x 16 tile cols
constexpr int R_P2 = 32;            // conv2 tiles computed: 2 x 16 (cols 14, 15 dropped)
constexpr int R_IR = 10, R_IC = 34; // conv1's input region
constexpr int R_HR = 6, R_HC = 36;  // the intermediate held: rows, cols
template <int MODE>
using RcuRegion = Region<R_IR, R_IC, MODE>;

size_t rcu_smem_bytes(int c) {
  return sizeof(bf16) * ((size_t)R_HR * R_HC * (c + 8) + RcuRegion<BY_ROW>::MAX_SIZE +
                         16 * R_P1 * LDV + 16 * CC * LDU);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    wino_rcu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ u2,
                    const bf16* __restrict__ b2, bf16* __restrict__ out, int c, int h, int w,
                    Strides xs, Strides os) {
  using R = RcuRegion<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldh = c + 8;
  // The intermediate: row i <-> image row 2 tr0 - 1 + i, column j <-> image
  // column 2 tc0 - 2 + j, channels contiguous.
  bf16* s_h = reinterpret_cast<bf16*>(smem);  // [R_HR][R_HC][ldh]
  bf16* s_in = s_h + R_HR * R_HC * ldh;       // conv1's region, R's layout
  bf16* s_v = s_in + R::MAX_SIZE;             // [16][R_P1 or R_P2][LDV]
  bf16* s_u = s_v + 16 * R_P1 * LDV;          // [16][CC][LDU]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ht = h / 2, wt = w / 2;
  const int tr0 = blockIdx.y * R_TR, tc0 = blockIdx.x * R_TC;
  const int bi = blockIdx.z;
  const bf16* xb = x + bi * xs.b;
  const int nc = c / CC, steps = (c / KB) * nc;  // (output block, chunk) steps

  // Columns 32..35 are read only by the dropped conv2 tiles; zero them all.
  for (int i = tid; i < R_HR * R_HC * ldh / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(s_h)[i] = 0u;

  // conv1 over tiles (tr0 - 1 + p / 16, tc0 - 1 + p % 16), reading relu(x)
  // from the region at image row 2 tr0 - 3, column 2 tc0 - 3; the next
  // chunk's region and U load while this one's products run.
  {
    const int y1 = 2 * tr0 - 3, x1 = 2 * tc0 - 3, xoff = x1 - R::origin(x1);
    const int p0 = (warp & 3) * 16, wk = (warp >> 2) * 32;
    float acc[4][4][4];
#pragma unroll
    for (int ab = 0; ab < 4; ++ab)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ab][n][j] = 0.f;
    R::load(s_in, xb, xs, h, w, y1, x1, 0, tid);
    load_u_chunk(s_u, u1, 0, c, c, 0, tid);
    cp_async_commit();
    for (int st = 0; st < steps; ++st) {
      const int kb = (st / nc) * KB, ci = st % nc, nx = st + 1;
      cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < R_P1 * CC; i += THREADS) {
        const int cc = i % CC, p = i / CC;
        const int pr = p >> 4, pc = p & 15;
        transform_patch<true>(R::at(s_in, cc, 2 * pr, xoff + 2 * pc), R::ROW, R::COL,
                              s_v + p * LDV + cc, R_P1 * LDV);
      }
      __syncthreads();
      if (nx < steps) R::load(s_in, xb, xs, h, w, y1, x1, (nx % nc) * CC, tid);
      cp_async_commit();
      gemm_fold<R_P1, 4>(s_v, s_u, p0, wk, lane, acc);
      __syncthreads();
      if (nx < steps) load_u_chunk(s_u, u1, (nx % nc) * CC, c, c, (nx / nc) * KB, tid);
      cp_async_commit();
      if (ci + 1 < nc) continue;
      // relu(acc + b1), zero outside the image, rounded once, into s_h
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + g + half * 8;
          const int pr = p >> 4, pc = p & 15;
          const int kk = kb + wk + n * 8 + 2 * t;
          const float bk0 = __bfloat162float(b1[kk]), bk1 = __bfloat162float(b1[kk + 1]);
#pragma unroll
          for (int ab = 0; ab < 4; ++ab) {
            const int i = 2 * pr + (ab >> 1) - 1, j = 2 * pc + (ab & 1);
            if (i < 0 || i >= R_HR) continue;
            const int gy = 2 * tr0 - 1 + i, gx = 2 * tc0 - 2 + j;
            const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
            const float v0 = inside ? fmaxf(acc[ab][n][2 * half] + bk0, 0.f) : 0.f;
            const float v1 = inside ? fmaxf(acc[ab][n][2 * half + 1] + bk1, 0.f) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(s_h + (i * R_HC + j) * ldh + kk) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
#pragma unroll
      for (int ab = 0; ab < 4; ++ab)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[ab][n][j] = 0.f;
    }
  }
  __syncthreads();

  // conv2 + b2 + x over tiles (tr0 + p / 16, tc0 + p % 16), p < 32
  {
    const int p0 = (warp & 1) * 16, wk = (warp >> 1) * 16;
    bf16* ob = out + bi * os.b;
    float acc[4][2][4];
#pragma unroll
    for (int ab = 0; ab < 4; ++ab)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ab][n][j] = 0.f;
    load_u_chunk(s_u, u2, 0, c, c, 0, tid);
    cp_async_commit();
    for (int st = 0; st < steps; ++st) {
      const int kb = (st / nc) * KB, ci = st % nc, nx = st + 1;
      cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < R_P2 * CC; i += THREADS) {
        const int cc = i % CC, p = i / CC;
        const int pr = p >> 4, pc = p & 15;
        transform_patch<false>(s_h + ((2 * pr) * R_HC + 2 * pc + 1) * ldh + ci * CC + cc,
                               R_HC * ldh, ldh, s_v + p * LDV + cc, R_P2 * LDV);
      }
      __syncthreads();
      gemm_fold<R_P2, 2>(s_v, s_u, p0, wk, lane, acc);
      __syncthreads();
      if (nx < steps) load_u_chunk(s_u, u2, (nx % nc) * CC, c, c, (nx / nc) * KB, tid);
      cp_async_commit();
      if (ci + 1 < nc) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + g + (j >> 1) * 8;
          const int pr = p >> 4, pc = p & 15;
          const int tr = tr0 + pr, tc = tc0 + pc;
          if (pc >= R_TC || tr >= ht || tc >= wt) continue;
          const int kk = kb + wk + n * 8 + 2 * t + (j & 1);
          const float bk = __bfloat162float(b2[kk]);
#pragma unroll
          for (int ab = 0; ab < 4; ++ab) {
            const int yy = 2 * tr + (ab >> 1), xx = 2 * tc + (ab & 1);
            const float res = __bfloat162float(xb[yy * xs.h + xx * xs.w + kk * xs.c]);
            ob[yy * os.h + xx * os.w + kk * os.c] = __float2bfloat16(acc[ab][n][j] + bk + res);
          }
        }
#pragma unroll
      for (int ab = 0; ab < 4; ++ab)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[ab][n][j] = 0.f;
    }
  }
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
// (c,). h and w even, c a multiple of 64 up to 256.
extern "C" int s3od_winograd_rcu(const void* x, const void* u1, const void* b1, const void* u2,
                                 const void* b2, void* out, int batch, int c, int h, int w,
                                 long long xsb, long long xsh, long long xsw, long long xsc,
                                 long long osb, long long osh, long long osw, long long osc,
                                 void* stream) {
  if (batch <= 0 || c <= 0 || c % KB || c > 256 || h <= 0 || w <= 0 || h % 2 || w % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w / 2 + R_TC - 1) / R_TC, (h / 2 + R_TR - 1) / R_TR, batch);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = rcu_smem_bytes(c);
  const Strides xs{xsb, xsh, xsw, xsc}, os{osb, osh, osw, osc};
  const int mode = load_mode(x, w, xs);
  auto kernel = mode == BY_ROW     ? wino_rcu_kernel<BY_ROW>
                : mode == BY_PIXEL ? wino_rcu_kernel<BY_PIXEL>
                                   : wino_rcu_kernel<BY_ELEMENT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(u2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), c, h,
      w, xs, os);
  return static_cast<int>(cudaGetLastError());
}
