// K10: the fused mask-head tail at the full canvas,
//   h1  = bf16(relu(conv3x3(relu(x), w1) + b1))   zero outside the image
//   h2  = bf16(relu(conv3x3(h1, w0) + b0))
//   out = bf16(h2 @ k1 + bk)
// with x the mask head's transposed-conv output (before its ReLU), C_in =
// 64 -> 64 -> C_mid = 96 (3 branches x 32) -> 3 masks at ViT-B/L.
//
// Replaces the TPU kernel `s3od_tpu/ops/experimental/mask_tail.py:_kernel`
// (via `mask_tail`). x is (B, H, W, C_in) in NHWC *logical* order with any
// strides (the decoder passes NCHW memory: W-contiguous rows), weights HWIO
// ([tap][c_in][c_out] as stored), out (B, H, W, n_out) through strides.
// The rounding points are the TPU kernel's: fp32 accumulation, each bias
// added in fp32 before the one rounding of its layer, h1's ring masked to
// zero after the ReLU.
//
// What bounds it on the H100: at 1024^2 the two convs are 7.7e10 + 1.16e11
// FLOP (0.195 ms on the tensor cores; 0.2025 ms with the 1x1) over 134 MB
// of input (0.04 ms): the operations. The point of the fusion is that h1
// and h2 (each 128-192 MB per 1024^2 image in bf16 as separate ops) never
// reach device memory.
//
// Design: rows streamed through a persistent 2-block cluster.
//   Work. A strip is 62 output columns: 64 h1 positions (one m64 tile) and
//   66 input pixels. The (image, strip, row) items, row fastest, are split
//   into equal contiguous runs, one per cluster (66 clusters on the H100's
//   132 SMs). A run walks its rows top to bottom, strip by strip: each h1
//   row is computed once, from a window of 3 input rows, and each output
//   row from a window of 3 h1 rows. At the run's start and at each strip
//   change the windows restart: 2 extra h1 rows and 4 extra input rows
//   (the segment's first output row needs h1 rows y - 1, y and input rows
//   y - 2 .. y + 1). 1024 = 16 x 62 + 32, so the 17th strip of a 1024-wide
//   image is half empty: 17 x 62 / 1024 - 1 = 2.9% of the positions are
//   computed and dropped, and the h1 halo (64 positions for 62 outputs)
//   another 3.2%.
//   Why a cluster. The weights stay resident (w1 73,728 B, w0 110,592 B),
//   and with the rings they exceed a block's 232,448 B. So conv1's output
//   channels are split over the pair: block r keeps w1's columns [32 r,
//   32 r + 32) (36,864 B) and computes those 32 channels of every h1 row;
//   its half row (channel groups 4 r .. 4 r + 3, 4 KB contiguous) goes to
//   the other block by one bulk copy (`cp.async.bulk.shared::cluster`)
//   that completes as transaction bytes on that block's barrier of the
//   row. conv2 is split by rows instead: block r computes the output rows
//   of parity r (segment-local), all 96 channels, from the whole w0, so the
//   1x1 needs no partial sums from the other block. Per block: 36,864 +
//   110,592 of weights, a ring of 4 input rows (33,792), a ring of 5 h1
//   rows (41,024), biases and k1 in fp32: 225,504 B with the alignment.
//   Warp roles (384 threads; registers 64 / 200 / 240 by `setmaxnreg`;
//   ptxas reports no spill for the NCHW and NHWC instances, 8 bytes for
//   the element-by-element one). Warpgroup 0 loads input rows: each row's
//   66 pixels x 64 channels into registers, then (once the ring slot is
//   free) ReLU'd into the slot, zero outside the image. Warpgroup 1
//   computes h1: per row 36 SS `wgmma` m64n32k16 (9 taps x 4 k16 slices),
//   the next row's products issued before this row's epilogue (two
//   accumulators; not across a strip change, whose input rows need the
//   slots of this one's); bias, ReLU, mask, bf16 into the ring, the half
//   row copied. Warpgroup 2 computes the output rows: 36 SS `wgmma`
//   m64n96k16, bias, ReLU, bf16, the 1x1 as per-thread dots (k1 and b0
//   read as vectors) reduced over the 4 lanes of a row, n_out stores a
//   pixel. The two compute warpgroups run at once, one's epilogue under
//   the other's products; mbarriers carry the rings (input rows: loader ->
//   conv1; h1 rows: both blocks' conv1 -> both blocks' conv2, and back, at
//   cluster scope). A wait still unmet after ~10 s traps, so a protocol
//   fault ends the launch instead of holding the card.
//   The im2col shift. Tap (dy, dx) is input row dy shifted by dx pixels. A
//   row is laid out [C/8][pixel][8 channels] (no swizzle): an 8-pixel x
//   16-byte core matrix is 128 contiguous bytes at any pixel offset, so the
//   shifted window is the K-major A operand starting dx x 16 bytes further
//   (`desc_nosw`, LBO the bytes between channel groups, SBO 128). h1 rows
//   use the same layout (64 positions); conv2's rows 62 and 63 read past a
//   row into the next channel group (or the ring's 64-byte pad): they are
//   computed and never stored. Weights are the K-major B operand, 128-byte
//   swizzled ([tap][c_out][c_in], written once per block). Descriptors are
//   one base plus immediates (`desc_add`).
//   Narrow N. An m64n32k16 reads A (2 KB) and B (1 KB) from shared memory
//   for 16 cycles of products, so conv1 is bound by shared memory (~24
//   cycles a slice); conv2's m64n96k16 (5 KB for 48 cycles) is not. RS
//   (A from registers) would read the same A bytes through ldmatrix unless
//   one fragment fed several rows' products: not built.
//   Input layouts (the entry accepts any strides, as before): BY_ROW (NCHW
//   memory: 16-byte chunks of 8 pixels of one channel, lanes on channels),
//   BY_PIXEL (NHWC memory: 16-byte chunks of 8 channels of one pixel), or
//   element by element. TMA would need 16-byte strides and a second pass
//   to transpose NCHW boxes; the loader does the ReLU and the layout in the
//   one pass. Both blocks of a pair load each input row (the second from
//   L2).
//   Tried and lost on the H100 (1024^2 b1, card held; the parent's kernel
//   0.95-0.96 ms in the same calls): the h1 halves by per-thread stores
//   and arrivals into the other block (0.78); a second input row in
//   the loader's registers (+0.04); conv2's next row issued before its
//   epilogue (+0.06, with its spills at 168 registers +0.4); 4 and 2
//   independent accumulators for conv1 and conv2 (0.73-0.82, the single
//   chains 0.58).
#include "hopper.cuh"

using namespace s3od;
using namespace s3od::hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int CIN = 64, CMID = 96, MAXO = 4;
constexpr int TCOL = 62, HC = 64, SC = 66;  // outputs, h1 positions, input pixels of a strip
constexpr int H1N = CIN / 2;                // conv1 output channels of a block
constexpr int IN_SLOTS = 4, H1_SLOTS = 5;
constexpr int IN_ROW = (CIN / 8) * SC * 16;  // bytes of an input row: [8][66][8] bf16
constexpr int H1_ROW = (CIN / 8) * HC * 16;  // bytes of an h1 row: [8][64][8] bf16
constexpr int THREADS = 384;
// Registers a thread: the loader gives conv1 and conv2 (the 64 x 96 fp32
// accumulator and the 1x1's operands) what it does not need: 64 + 200 +
// 240 = 3 x 168, the launch's (at 168 each, conv2 spilled).
constexpr int LOADER_REGS = 64, CONV1_REGS = 200, CONV2_REGS = 240;

struct Strides {
  long long b, h, w, c;
};

// Byte offsets from the 1024-aligned base.
struct Layout {
  static constexpr int W1 = 0;                          // [9][32 rows][64] swizzled
  static constexpr int W0 = W1 + 9 * H1N * 128;         // [9][96 rows][64] swizzled
  static constexpr int IN = W0 + 9 * CMID * 128;        // [IN_SLOTS] input rows
  static constexpr int H1 = IN + IN_SLOTS * IN_ROW;     // [H1_SLOTS] h1 rows + 64 B pad
  static constexpr int F32 = H1 + H1_SLOTS * H1_ROW + 64;
  static constexpr int B1 = F32, B0 = B1 + 4 * H1N, K1 = B0 + 4 * CMID, BK = K1 + 4 * CMID * MAXO;
  static constexpr int BAR = BK + 4 * MAXO;  // in_full, in_empty, h1_full, h1_empty
  static constexpr int END = BAR + 8 * (2 * IN_SLOTS + 2 * H1_SLOTS);
  static constexpr int BYTES = 1024 + END;
};
static_assert(Layout::BYTES <= 232448, "over a block's shared memory");
static_assert(Layout::W0 % 1024 == 0 && (9 * H1N * 128) % 1024 == 0, "swizzle atoms");
static_assert(Layout::K1 % 16 == 0 && Layout::B0 % 8 == 0, "vector loads of k1 and b0");

// How a block reads an input row: element by element (any strides), in
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

// A run of the cluster's items cut into segments of one (image, strip).
struct Segment {
  int img, strip, y0, rows;
};
__device__ __forceinline__ bool next_segment(int& idx, int end, int strips, int h, Segment& sg) {
  if (idx >= end) return false;
  const int per_img = strips * h;
  sg.img = idx / per_img;
  const int r = idx - sg.img * per_img;
  sg.strip = r / h;
  sg.y0 = r - sg.strip * h;
  sg.rows = min(end - idx, h - sg.y0);
  idx += sg.rows;
  return true;
}

// mbar_wait / mbar_wait_cluster that give up after ~10 s (the global
// timer, read every 1024 polls): a protocol fault then ends the launch
// with an error instead of holding the card.
template <bool CLUSTER>
__device__ __forceinline__ void wait_bar(uint64_t* bar, int phase) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (CLUSTER)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(phase)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(phase)
          : "memory");
    if (!done && (polls & 1023) == 1023) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 10000000000ull)
        __trap();
    }
  }
}

// The loader's walk over the input rows of a run: each segment's rows
// y0 - 2 .. y0 + rows + 1 in order.
struct RowWalk {
  int idx, end, strips, h, z;
  Segment sg;
  bool ok;
  __device__ void init(int s, int e, int st, int hh) {
    idx = s;
    end = e;
    strips = st;
    h = hh;
    ok = next_segment(idx, end, strips, h, sg);
    z = sg.y0 - 2;
  }
  __device__ void advance() {
    if (++z > sg.y0 + sg.rows + 1) {
      ok = next_segment(idx, end, strips, h, sg);
      z = sg.y0 - 2;
    }
  }
};

// conv1's walk over the h1 rows of a run: per segment j = 0 .. rows + 1,
// image row y0 - 1 + j from the segment's input rows q .. q + 2 (global
// input row numbers), into h1 row g (global h1 row number).
struct H1Row {
  int q, g, c0;
  bool inside, last, valid;
};
struct H1Walk {
  int idx, end, strips, h, j, q_seg, g;
  Segment sg;
  bool ok;
  __device__ void init(int s, int e, int st, int hh) {
    idx = s;
    end = e;
    strips = st;
    h = hh;
    j = 0;
    q_seg = 0;
    g = 0;
    ok = next_segment(idx, end, strips, h, sg);
  }
  __device__ H1Row next() {
    H1Row r;
    r.valid = ok;
    if (!ok) return r;
    const int zr = sg.y0 - 1 + j;
    r.q = q_seg + j;
    r.g = g++;
    r.c0 = sg.strip * TCOL;
    r.inside = zr >= 0 && zr < h;
    r.last = j == sg.rows + 1;
    if (r.last) {
      q_seg += sg.rows + 4;
      j = 0;
      ok = next_segment(idx, end, strips, h, sg);
    } else {
      ++j;
    }
    return r;
  }
};

// A descriptor `bytes` further on (the start address field counts 16-byte
// units; offsets stay inside shared memory, so no carry leaves the field).
// Adding immediates to one base keeps the 36 descriptors of a row's
// products from being held in registers across rows.
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) { return d + (bytes >> 4); }

__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  b = __hmax2(b, __floats2bfloat162_rn(0.f, 0.f));
  return *reinterpret_cast<uint32_t*>(&b);
}

// The loader's registers for one input row: up to 5 chunks of 16 bytes
// (BY_PIXEL, BY_ROW) or 33 elements (BY_ELEMENT) a thread.
constexpr int LOAD_CHUNKS = 5, LOAD_ELEMS = (SC * CIN + 127) / 128;

template <int MODE>
struct RowRegs {
  uint4 v[MODE == BY_ELEMENT ? 1 : LOAD_CHUNKS];
  bf16 e[MODE == BY_ELEMENT ? LOAD_ELEMS : 1];
};

// Input row z of image `img` for the strip starting at column c0 into
// registers (zeros outside the image).
template <int MODE>
__device__ __forceinline__ void load_row(RowRegs<MODE>& rg, const bf16* xb, int z, int c0, int h,
                                         int w, const Strides& xs, int tid) {
  const bool row_in = z >= 0 && z < h;
  if (MODE == BY_PIXEL) {
#pragma unroll
    for (int k = 0; k < LOAD_CHUNKS; ++k) {
      const int i = tid + 128 * k, p = i >> 3, g = i & 7;  // lanes on channel groups
      const int gx = c0 - 2 + p;
      rg.v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < SC * 8 && row_in && gx >= 0 && gx < w)
        rg.v[k] = *reinterpret_cast<const uint4*>(xb + z * xs.h + gx * xs.w + g * 8);
    }
  } else if (MODE == BY_ROW) {
    const int xa = (c0 - 2) & ~7;
#pragma unroll
    for (int k = 0; k < LOAD_CHUNKS; ++k) {
      const int i = tid + 128 * k, ci = i & 63, cq = i >> 6;  // lanes on channels
      const int gx = xa + 8 * cq;
      rg.v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (row_in && gx >= 0 && gx < w)
        rg.v[k] = *reinterpret_cast<const uint4*>(xb + z * xs.h + gx + ci * xs.c);
    }
  } else {
#pragma unroll
    for (int k = 0; k < LOAD_ELEMS; ++k) {
      const int i = tid + 128 * k, p = i >> 6, ci = i & 63;
      const int gx = c0 - 2 + p;
      rg.e[k] = __float2bfloat16(0.f);
      if (i < SC * CIN && row_in && gx >= 0 && gx < w)
        rg.e[k] = xb[z * xs.h + gx * xs.w + ci * xs.c];
    }
  }
}

// The registers ReLU'd into a ring slot, [C/8][66][8].
template <int MODE>
__device__ __forceinline__ void store_row(const RowRegs<MODE>& rg, unsigned char* slot, int c0,
                                          int tid) {
  if (MODE == BY_PIXEL) {
#pragma unroll
    for (int k = 0; k < LOAD_CHUNKS; ++k) {
      const int i = tid + 128 * k, p = i >> 3, g = i & 7;
      if (i < SC * 8) {
        const uint4 v = rg.v[k];
        *reinterpret_cast<uint4*>(slot + g * (SC * 16) + p * 16) =
            make_uint4(relu2(v.x), relu2(v.y), relu2(v.z), relu2(v.w));
      }
    }
  } else if (MODE == BY_ROW) {
    const int xa = (c0 - 2) & ~7;
#pragma unroll
    for (int k = 0; k < LOAD_CHUNKS; ++k) {
      const int i = tid + 128 * k, ci = i & 63, cq = i >> 6;
      const int p0 = xa + 8 * cq - (c0 - 2);
      const bf16* e = reinterpret_cast<const bf16*>(&rg.v[k]);
      unsigned char* base = slot + (ci >> 3) * (SC * 16) + (ci & 7) * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + j;
        if (p >= 0 && p < SC)
          *reinterpret_cast<bf16*>(base + p * 16) = __float2bfloat16(fmaxf(__bfloat162float(e[j]), 0.f));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < LOAD_ELEMS; ++k) {
      const int i = tid + 128 * k, p = i >> 6, ci = i & 63;
      if (i < SC * CIN)
        *reinterpret_cast<bf16*>(slot + (ci >> 3) * (SC * 16) + p * 16 + (ci & 7) * 2) =
            __float2bfloat16(fmaxf(__bfloat162float(rg.e[k]), 0.f));
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    mask_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const bf16* __restrict__ b1, const bf16* __restrict__ w0,
                     const bf16* __restrict__ b0, const bf16* __restrict__ k1,
                     const bf16* __restrict__ bk, bf16* __restrict__ out, int h, int w, int nout,
                     int strips, int items, Strides xs, Strides os) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* s_w1 = reinterpret_cast<bf16*>(sm + Layout::W1);
  bf16* s_w0 = reinterpret_cast<bf16*>(sm + Layout::W0);
  unsigned char* s_in = sm + Layout::IN;
  unsigned char* s_h1 = sm + Layout::H1;
  float* s_b1 = reinterpret_cast<float*>(sm + Layout::B1);
  float* s_b0 = reinterpret_cast<float*>(sm + Layout::B0);
  float* s_k1 = reinterpret_cast<float*>(sm + Layout::K1);  // [CMID][MAXO]
  float* s_bk = reinterpret_cast<float*>(sm + Layout::BK);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(sm + Layout::BAR);
  uint64_t* in_empty = in_full + IN_SLOTS;
  uint64_t* h1_full = in_empty + IN_SLOTS;
  uint64_t* h1_empty = h1_full + H1_SLOTS;

  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127;
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1;
  const int cluster = blockIdx.x >> 1, clusters = gridDim.x >> 1;
  const int start = items * cluster / clusters, end = items * (cluster + 1) / clusters;

  // The block's weights, once: w1's columns [32 rank, +32) and all of w0 as
  // K-major B operands ([tap][c_out row][c_in], 128-byte swizzle), 8
  // output channels (16 bytes of a HWIO row) a step.
  for (int i = tid; i < 9 * CIN * (H1N / 8); i += THREADS) {
    const int row = i / (H1N / 8), n0 = (i % (H1N / 8)) * 8, tap = row / CIN, ci = row % CIN;
    const uint4 v = *reinterpret_cast<const uint4*>(w1 + (size_t)row * CIN + H1N * rank + n0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j;
      *reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(s_w1) + tap * H1N * 128 + n * 128 +
                               (((ci >> 3) ^ (n & 7)) << 4) + (ci & 7) * 2) = e[j];
    }
  }
  for (int i = tid; i < 9 * CIN * (CMID / 8); i += THREADS) {
    const int row = i / (CMID / 8), n0 = (i % (CMID / 8)) * 8, tap = row / CIN, ci = row % CIN;
    const uint4 v = *reinterpret_cast<const uint4*>(w0 + (size_t)row * CMID + n0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j;
      *reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(s_w0) + tap * CMID * 128 + n * 128 +
                               (((ci >> 3) ^ (n & 7)) << 4) + (ci & 7) * 2) = e[j];
    }
  }
  for (int i = tid; i < CMID * MAXO; i += THREADS) {
    const int m = i / MAXO, o = i - m * MAXO;
    s_k1[i] = o < nout ? __bfloat162float(k1[m * nout + o]) : 0.f;
  }
  for (int i = tid; i < CMID; i += THREADS) s_b0[i] = __bfloat162float(b0[i]);
  for (int i = tid; i < H1N; i += THREADS) s_b1[i] = __bfloat162float(b1[H1N * rank + i]);
  if (tid < MAXO) s_bk[tid] = tid < nout ? __bfloat162float(bk[tid]) : 0.f;
  if (tid == 0) {
    for (int s = 0; s < IN_SLOTS; ++s) {
      mbar_init(&in_full[s], 128);   // the loader's threads
      mbar_init(&in_empty[s], 128);  // conv1's threads
    }
    for (int s = 0; s < H1_SLOTS; ++s) {
      mbar_init(&h1_full[s], 1);     // this block's conv1 (and the other's half as bytes)
      mbar_init(&h1_empty[s], 8);    // conv2's warps of both blocks
    }
    fence_barrier_init();
  }
  fence_proxy_async();  // the weights, before the products read them
  __syncthreads();
  cluster_sync();  // the other block's barriers are initialised

  if (wgi == 0) {
    // ---- the loader ----
    setmaxnreg_dec<LOADER_REGS>();
    RowWalk wk;
    wk.init(start, end, strips, h);
    RowRegs<MODE> ra;
    int q = 0, ca = 0;
    auto load = [&](RowRegs<MODE>& rg, int& c0) {
      c0 = wk.sg.strip * TCOL;
      load_row<MODE>(rg, x + wk.sg.img * xs.b, wk.z, c0, h, w, xs, t);
      wk.advance();
    };
    auto put = [&](const RowRegs<MODE>& rg, int c0) {
      const int s = q % IN_SLOTS;
      wait_bar<false>(&in_empty[s], ((q / IN_SLOTS) & 1) ^ 1);
      store_row<MODE>(rg, s_in + s * IN_ROW, c0, t);
      fence_proxy_async();
      mbar_arrive(&in_full[s]);
      ++q;
    };
    // Each row's loads are in flight while the loader waits for its slot.
    // (A second row in registers, loaded before the first is stored, ran
    // slower on the H100.)
    while (wk.ok) {
      load(ra, ca);
      put(ra, ca);
    }
  } else if (wgi == 1) {
    // ---- conv1: h1 rows, this block's 32 channels, into both blocks ----
    // Two accumulators: row j + 1's products are issued before row j's
    // epilogue, except across a segment change (the next segment's input
    // rows need the slots of this one's).
    const int lrow = (t >> 5) * 16 + ((t & 31) >> 2), quad = t & 3;
    setmaxnreg_inc<CONV1_REGS>();
    const uint64_t dw1 = desc_sw128(s_w1);
    H1Walk hw;
    hw.init(start, end, strips, h);
    int waited = -1;  // input rows waited for: [0, waited]
    float acc0[16], acc1[16];
    auto issue = [&](const H1Row& r, float (&acc)[16]) {
      for (; waited < r.q + 2; ++waited)
        wait_bar<false>(&in_full[(waited + 1) % IN_SLOTS], ((waited + 1) / IN_SLOTS) & 1);
      wgmma_fence();
      if (r.inside) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint64_t da = desc_nosw(s_in + ((r.q + dy) % IN_SLOTS) * IN_ROW, SC * 16, 128);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int ks = 0; ks < CIN / 16; ++ks)
              WgmmaSS<H1N>::mma(acc, desc_add(da, dx * 16 + ks * 2 * (SC * 16)),
                                desc_add(dw1, (3 * dy + dx) * H1N * 128 + ks * 32),
                                dy + dx + ks > 0);
        }
      }
      wgmma_commit();  // (an empty group outside the image)
    };
    auto epilogue = [&](const H1Row& r, float (&acc)[16]) {
      fence_regs(acc);
      mbar_arrive(&in_empty[r.q % IN_SLOTS]);
      if (r.last) {  // the segment's last two input rows
        mbar_arrive(&in_empty[(r.q + 1) % IN_SLOTS]);
        mbar_arrive(&in_empty[(r.q + 2) % IN_SLOTS]);
      }
      const int hs = r.g % H1_SLOTS;
      wait_bar<true>(&h1_empty[hs], ((r.g / H1_SLOTS) & 1) ^ 1);
      unsigned char* dst = s_h1 + hs * H1_ROW;
#pragma unroll
      for (int jn = 0; jn < H1N / 8; ++jn) {
        const int col = 8 * jn + 2 * quad;  // of the block's 32
        const float bb0 = s_b1[col], bb1 = s_b1[col + 1];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int p = lrow + 8 * rr, gx = r.c0 - 1 + p;
          const bool in = r.inside && gx >= 0 && gx < w;
          const float v0 = in ? fmaxf(acc[4 * jn + 2 * rr] + bb0, 0.f) : 0.f;
          const float v1 = in ? fmaxf(acc[4 * jn + 2 * rr + 1] + bb1, 0.f) : 0.f;
          const uint32_t packed = pack_bf16(v0, v1);
          *reinterpret_cast<uint32_t*>(dst + (4 * rank + jn) * (HC * 16) + p * 16 + 4 * quad) =
              packed;
        }
      }
      fence_proxy_async();
      named_sync(1, 128);
      if (t == 0) {  // the half row (channel groups 4 rank .. 4 rank + 3) to the other block
        unsigned char* half = dst + rank * (H1_ROW / 2);
        mbar_expect_tx(&h1_full[hs], H1_ROW / 2);
        bulk_copy_to_block(half, half, H1_ROW / 2, &h1_full[hs], peer);
      }
    };
    H1Row cur = hw.next();
    if (cur.valid) issue(cur, acc0);
    for (int par = 0; cur.valid; par ^= 1) {
      H1Row nxt = hw.next();
      const bool ahead = nxt.valid && !cur.last;
      if (ahead) {
        if (par)
          issue(nxt, acc0);
        else
          issue(nxt, acc1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      if (par)
        epilogue(cur, acc1);
      else
        epilogue(cur, acc0);
      if (nxt.valid && !ahead) {
        if (par)
          issue(nxt, acc0);
        else
          issue(nxt, acc1);
      }
      cur = nxt;
    }
  } else {
    // ---- conv2 + 1x1: output rows of this block's parity ----
    // h1 rows are released in order, once no later product of this block
    // reads them. (Issuing row i + 2's products before row i's epilogue,
    // with a second accumulator, ran slower on the H100.)
    setmaxnreg_inc<CONV2_REGS>();
    const int lrow = (t >> 5) * 16 + ((t & 31) >> 2), quad = t & 3;
    int idx = start;
    Segment sg;
    int g = 0, waited = -1, released = 0;  // h1 rows waited for: [0, waited]
    const uint64_t dw0 = desc_sw128(s_w0);
    float acc[CMID / 2];
    auto wait_h1 = [&](int upto) {
      for (; waited < upto; ++waited)
        wait_bar<true>(&h1_full[(waited + 1) % H1_SLOTS], ((waited + 1) / H1_SLOTS) & 1);
    };
    auto release_h1 = [&](int upto) {  // rows [released, upto), each waited for
      wait_h1(upto - 1);
      __syncwarp();
      for (; released < upto; ++released) {
        if ((t & 31) == 0) {
          mbar_arrive(&h1_empty[released % H1_SLOTS]);
          mbar_arrive_cluster(&h1_empty[released % H1_SLOTS], peer);
        }
      }
    };
    auto issue = [&](int i) {
      wait_h1(g + i + 2);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint64_t da = desc_nosw(s_h1 + ((g + i + dy) % H1_SLOTS) * H1_ROW, HC * 16, 128);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ks = 0; ks < CIN / 16; ++ks)
            WgmmaSS<CMID>::mma(acc, desc_add(da, dx * 16 + ks * 2 * (HC * 16)),
                               desc_add(dw0, (3 * dy + dx) * CMID * 128 + ks * 32),
                               dy + dx + ks > 0);
      }
      wgmma_commit();
    };
    auto epilogue = [&](int i) {
      fence_regs(acc);
      const int c0 = sg.strip * TCOL, y = sg.y0 + i;
      bf16* ob = out + sg.img * os.b;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float part[MAXO] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jn = 0; jn < CMID / 8; ++jn) {
          const int col = 8 * jn + 2 * quad;
          const float2 bb = *reinterpret_cast<const float2*>(s_b0 + col);
          const float h0 =
              __bfloat162float(__float2bfloat16(fmaxf(acc[4 * jn + 2 * rr] + bb.x, 0.f)));
          const float h1v =
              __bfloat162float(__float2bfloat16(fmaxf(acc[4 * jn + 2 * rr + 1] + bb.y, 0.f)));
          const float4 ka = *reinterpret_cast<const float4*>(s_k1 + col * MAXO);
          const float4 kb = *reinterpret_cast<const float4*>(s_k1 + (col + 1) * MAXO);
          part[0] += h0 * ka.x + h1v * kb.x;
          part[1] += h0 * ka.y + h1v * kb.y;
          part[2] += h0 * ka.z + h1v * kb.z;
          part[3] += h0 * ka.w + h1v * kb.w;
        }
#pragma unroll
        for (int o = 0; o < MAXO; ++o) {
          part[o] += __shfl_xor_sync(0xffffffffu, part[o], 1);
          part[o] += __shfl_xor_sync(0xffffffffu, part[o], 2);
        }
        const int m = lrow + 8 * rr, gx = c0 + m;
        if (quad == 0 && m < TCOL && gx < w) {
#pragma unroll
          for (int o = 0; o < MAXO; ++o)
            if (o < nout) ob[y * os.h + gx * os.w + o * os.c] = __float2bfloat16(part[o] + s_bk[o]);
        }
      }
    };
    while (next_segment(idx, end, strips, h, sg)) {
      for (int i = rank; i < sg.rows; i += 2) {
        release_h1(g + i);
        issue(i);
        wgmma_wait<0>();
        release_h1(g + i + 2);
        epilogue(i);
      }
      release_h1(g + sg.rows + 2);
      g += sg.rows + 2;
    }
  }
  cluster_sync();  // no block leaves while the other may write to it
}

int launch(const void* x, const void* w1, const void* b1, const void* w0, const void* b0,
           const void* k1, const void* bk, void* out, int batch, int h, int w, int nout,
           Strides xs, Strides os, cudaStream_t st) {
  const int mode = load_mode(x, w, xs);
  auto kernel = mode == BY_ROW     ? mask_tail_kernel<BY_ROW>
                : mode == BY_PIXEL ? mask_tail_kernel<BY_PIXEL>
                                   : mask_tail_kernel<BY_ELEMENT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Layout::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int strips = (w + TCOL - 1) / TCOL;
  // item counts whose products with the cluster index stay within an int
  if ((long long)batch * strips * h > (1 << 23)) return static_cast<int>(cudaErrorInvalidValue);
  const int items = batch * strips * h;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout::BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one cluster a pair of SMs, at most as many as are resident at once
  static int max_clusters[3] = {0, 0, 0};
  if (max_clusters[mode] <= 0) {
    e = cudaOccupancyMaxActiveClusters(&max_clusters[mode], reinterpret_cast<const void*>(kernel),
                                       &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (max_clusters[mode] <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int clusters = max_clusters[mode] < items ? max_clusters[mode] : items;
  cfg.gridDim = dim3(2 * clusters);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                         static_cast<const bf16*>(b1), static_cast<const bf16*>(w0),
                         static_cast<const bf16*>(b0), static_cast<const bf16*>(k1),
                         static_cast<const bf16*>(bk), static_cast<bf16*>(out), h, w, nout, strips,
                         items, xs, os);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, h, w, c_in), out: (batch, h, w, n_out), both through strides
// (b, h, w, c); w1: (3, 3, c_in, c_in), w0: (3, 3, c_in, c_mid), k1:
// (c_mid, n_out), all contiguous bf16 and 16-byte aligned. (c_in, c_mid)
// is (64, 96), the mask head of every ViT config but the tiny test ones;
// n_out is 1..4.
extern "C" int s3od_mask_tail(const void* x, const void* w1, const void* b1, const void* w0,
                              const void* b0, const void* k1, const void* bk, void* out,
                              int batch, int h, int w, int cin, int cmid, int nout, long long xsb,
                              long long xsh, long long xsw, long long xsc, long long osb,
                              long long osh, long long osw, long long osc, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || nout < 1 || nout > MAXO || cin != CIN || cmid != CMID)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xsb, xsh, xsw, xsc}, os{osb, osh, osw, osc};
  return launch(x, w1, b1, w0, b0, k1, bk, out, batch, h, w, nout, xs, os,
                static_cast<cudaStream_t>(stream));
}
