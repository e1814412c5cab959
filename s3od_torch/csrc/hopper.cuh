// Shared Hopper (sm_90a) building blocks of the port's warp-specialised
// kernels (K2, K4, K5, K8, K9a/K9b's Winograd kernels, K10, E1/E3a/E4,
// E2's bulk variant; K7 and K3/K6 through `flash_fwd_ws.cuh`), as inline
// PTX: mbarriers, TMA tensor loads, stores and reduce-adds, the wgmma
// shared-memory descriptors (128-byte-swizzled tiles; K-major tiles
// without swizzle), wgmma fences and groups, `wgmma.mma_async` m64nNk16
// bf16 -> fp32 (SS: both operands in shared memory, B K-major or
// MN-major, or both MN-major; RS: A from registers), `setmaxnreg`, the
// SFU's exp2, the turns of the consumer warpgroups, thread block clusters
// (the cluster barrier, `mapa`, loads from, bulk copies into and mbarrier
// arrivals on another block's shared memory), 1-D bulk copies, and the
// host-side encoding of TMA tensor maps (bf16 swizzled tiles, bf16 plain
// boxes, fp32 rows, fp32 swizzled boxes).
//
// No CuTe or CUTLASS: every source builds with its own nvcc in seconds.
// `cuTensorMapEncodeTiled` is a driver function; it is reached through
// the runtime's `cudaGetDriverEntryPoint*`, so the link needs no -lcuda.
//
// Tiles are loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte
// aligned shared memory, one 64-column (128-byte) bf16 atom wide; a wider
// tile is several atoms side by side. The descriptors below describe the
// same layout to wgmma:
//   K-major operand (K contiguous): 8-row groups 1024 bytes apart (SBO);
//     the k16 slices of an atom start 32 bytes apart.
//   MN-major operand (MN contiguous, wgmma's transpose bit): 8-row K
//     groups 1024 bytes apart (SBO), 64-element MN atoms `atom_bytes`
//     apart (LBO); the k16 slices start 2048 bytes apart.
#pragma once

#include <cuda.h>

#include "mma.cuh"  // smem_addr, pack_bf16

namespace s3od {
namespace hopper {

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive once and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of parity `phase`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// Shared -> global tensor stores, completed through a bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Shared -> global tensor reduce-add: each element of the box is added
// to global memory in L2 (an fp32 map: a float add), completed through a
// bulk group like the stores.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's committed stores have read their shared
// memory (which may then be overwritten) / have completed.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- thread block clusters ---------------------------------------------------
// A cluster's blocks run on neighbouring SMs and address each other's
// shared memory ("distributed shared memory"): `mapa` turns a local
// shared address into the same offset in block `rank` of the cluster.

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every non-exited thread of the cluster arrives, then waits: the release
// and acquire order each block's shared-memory writes (mbarrier inits
// included) before the other blocks' accesses after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ uint32_t mapa(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
// Two floats from block `rank`'s shared memory at the offset of `p`.
__device__ __forceinline__ float2 ld_shared_cluster_f2(const void* p, uint32_t rank) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(mapa(p, rank)));
  return v;
}
// Arrive on the barrier at the offset of `bar` in block `rank`, releasing
// this thread's earlier memory accesses at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   mapa(bar, rank))
               : "memory");
}
// mbar_wait with cluster-scope acquire: for barriers other blocks arrive on.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int phase) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
  } while (!done);
}
// A 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16) from this block's shared
// memory at `src` to the same offset as `dst` in block `rank`, completing
// as transaction bytes on the barrier at the offset of `bar` there.
__device__ __forceinline__ void bulk_copy_to_block(const void* dst, const void* src, uint32_t bytes,
                                                   uint64_t* bar, uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          mapa(dst, rank)),
      "r"(smem_addr(src)), "r"(bytes), "r"(mapa(bar, rank))
      : "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled bf16 tile in shared memory starting at
// `p` (inside a 1024-byte aligned atom): SBO 1024 bytes, LBO `lbo` bytes
// (read only for MN-major operands wider than one atom).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo = 16) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Descriptor of a K-major bf16 tile without swizzle: core matrices of 8
// rows x 16 bytes (128 contiguous bytes), `lbo` bytes apart along K and
// `sbo` bytes apart along M (or N). A start 16 bytes further is the tile
// one row further on, so a shifted window of rows is a valid operand.
__device__ __forceinline__ uint64_t desc_nosw(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins accumulator registers at this point of the program, so that the
// compiler moves no read or write of them across an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// ---- the SFU -----------------------------------------------------------------

// 2^x by one MUFU.EX2, subnormal results flushed to zero. exp2f keeps them
// (ex2.approx.f32), at the cost of a range check and two multiplies per
// call around the same MUFU.EX2.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- setmaxnreg ------------------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- warp specialisation ---------------------------------------------------
// A block of one producer warpgroup and NC consumer warpgroups; registers a
// thread after `setmaxnreg`, the whole 64K register file split as
// CUTLASS and FlashAttention-3 split it.
__host__ __device__ constexpr int ws_threads(int nc) { return 128 * (nc + 1); }
__host__ __device__ constexpr int ws_producer_regs(int nc) { return nc == 2 ? 24 : 32; }
__host__ __device__ constexpr int ws_consumer_regs(int nc) { return nc == 2 ? 240 : 160; }

// The NC consumer warpgroups take turns issuing their products, in a ring
// (named barriers 1..NC: warpgroup h waits on 1 + h and, once its products
// are issued, releases the next one's), so one's softmax runs under the
// others' products. Each takes the same number of turns; the last
// warpgroup opens the first (`turns_open`) and does not release after its
// last.
template <int NC>
__device__ __forceinline__ void turns_open(int h) {
  if (h == NC - 1) named_arrive(1, 256);
}
__device__ __forceinline__ void turn_begin(int h) { named_sync(1 + h, 256); }
template <int NC>
__device__ __forceinline__ void turn_end(int h, bool last) {
  if (!(last && h == NC - 1)) named_arrive(1 + (h + 1) % NC, 256);
}

// ---- the accumulator fragment ----------------------------------------------
// Thread t of a warpgroup holds, of the 64 x N fp32 tile, d[4j + e] at
// row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column 8 j + 2 (t % 4) +
// e % 2. The A fragment of an RS wgmma over k16 slice s is the same
// layout's columns 16 s .. 16 s + 15, packed to bf16 pairs:
// {d[8s], d[8s+1]}, {d[8s+2], d[8s+3]}, {d[8s+4], d[8s+5]}, {d[8s+6], d[8s+7]}
// (`pack_a`).
template <int S>
__device__ __forceinline__ void pack_a(uint32_t (&a)[S][4], const float (&d)[8 * S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a[s][0] = pack_bf16(d[8 * s], d[8 * s + 1]);
    a[s][1] = pack_bf16(d[8 * s + 2], d[8 * s + 3]);
    a[s][2] = pack_bf16(d[8 * s + 4], d[8 * s + 5]);
    a[s][3] = pack_bf16(d[8 * s + 6], d[8 * s + 7]);
  }
}

// d (64 x N, fp32) += A (64 x 16) @ B (16 x N): A and B from shared memory
// through descriptors, both K-major. scale_d == 0 overwrites d.
template <int N>
struct WgmmaSS;
// The same with A from registers (four bf16 pairs a thread) and B
// MN-major (wgmma's transpose bit).
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<192> {
  __device__ __forceinline__ static void mma(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// SS with B MN-major (N contiguous, wgmma's transpose bit), as TMA loads a
// row-major (K, N) tile: the Winograd GEMM's U.
template <int N>
struct WgmmaSSBt;

template <>
struct WgmmaSSBt<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// SS with A and B both MN-major (both transpose bits): A stored (K, M)
// with M contiguous, B (K, N) with N contiguous, as a product of two
// transposed tiles needs (K8's dQ = dS K from dS^T and K as stored).
template <int N>
struct WgmmaSSt;

template <>
struct WgmmaSSt<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// ---- host: TMA tensor maps -------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a row-major tensor of `rank` (<= 4) dimensions, listed
// innermost first (`dims`; `strides` in bytes for dims 1..rank-1), read in
// boxes of `box` elements with the given element type and swizzle;
// elements outside the tensor load as zeros. The map holds the pointer,
// so it is encoded anew on every call. Returns 0 or a CUDA error code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                      const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t d[4], s[3];
  cuuint32_t b[4], e[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
// bf16 boxes without swizzle (a region read by plain shared loads); the
// box's innermost extent must span a multiple of 16 bytes.
inline int encode_bf16_plain_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                                 const uint64_t* strides, const uint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}
// bf16 tiles with the 128-byte swizzle (the wgmma operands above).
inline int encode_bf16_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                           const uint64_t* strides, const uint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}
// fp32 rows without swizzle (per-row statistics such as lse); the box's
// innermost extent must span a multiple of 16 bytes.
inline int encode_f32_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                          const uint64_t* strides, const uint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, rank, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// fp32 boxes with the 128-byte swizzle (a 32-column box: a staged tile
// written from accumulator fragments without bank conflicts).
inline int encode_f32_sw128_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                                const uint64_t* strides, const uint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, rank, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// Streaming multiprocessors of the current device (persistent grids).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  return n;
}

}  // namespace hopper
}  // namespace s3od
