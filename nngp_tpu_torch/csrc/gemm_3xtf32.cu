// 3xTF32 GEMM for Hopper (sm_90a), bound to Python with ctypes:
//
//     C = alpha * op(A) @ op(B) + beta * C        (fp32 in, fp32 out)
//
// op is the identity or the transpose, read from the strides by the wrapper
// (nngp_tpu_torch/ops/matmul.py). It is what precision='high' runs on the
// card in the Nystrom tier (gp/nystrom.py): the panel moments psi = K_pm W,
// C += psi^T psi, b += psi^T y, M1 += psi_K^T psi, the RPCholesky residual
// g = K - F F_S^T and update F_new = g[:, perm] L^-T, and the predict's
// projections and mean.
//
// Replaces: XLA's dot at Precision.HIGH, which nngp_tpu/gp/nystrom.py runs
// under jax.default_matmul_precision('high') (_panel_delta, _sharded_panel_fn,
// NystromPosterior._predict_scaled, _rpchol_panel, _rpchol_update). There is
// no Pallas source. On the TPU that dot is bf16_3x: each fp32 operand is
// split into a high and a low bf16 part and the three large cross products
// are summed. Here the parts are TF32 (10 explicit mantissa bits):
//
//     big = rna_tf32(x),  small = rna_tf32(x - big)      (cvt.rna.tf32.f32)
//     a b ~= small_a big_b + big_a small_b + big_a big_b   (fp32 accumulate)
//
// the construction CUTLASS calls OpMultiplyAddFastF32. Each product of TF32
// parts is exact in fp32; the dropped small_a small_b term and the rounding
// of the small parts leave ~3 * 2^-22 of |a b| per product, against
// ~2^-16 for bf16_3x, so this is more accurate than the TPU's 'high'.
// The TF32 lives inside this file's instructions: the global TF32
// switches that utils/device.py turns off are never touched.
//
// What bounds it on this card. The FLOPs: 3 * 2 M N K on the TF32 tensor
// cores (495 TFLOP/s dense on an H100 SXM), against the bytes (each operand
// read once, C written once and read once when beta != 0) at 3.35 TB/s. The
// Nystrom panel (16,384 x 2,048) @ (2,048 x 2,048) is 412 GFLOP of 3xTF32
// work, 0.83 ms, against 285 MB, 0.085 ms: compute-bound. A product with
// one output column (b += psi^T y, the predict's mean) is bytes-bound: A
// read once is all of its time (0.040 ms for the 2,048 x 16,384 panel).
//
// The error rule, common to both kernels below. Each K-step's 32 terms (3
// TF32 products each, the small terms first) are summed into a partial sum
// that starts at zero, which is then added to the running sum with an fp32
// add. The tensor cores do not round their sums to nearest: with the whole
// K range in the MMA's own accumulator, the error against fp64 at the
// Nystrom panel's C += psi^T psi (K = 16,384) was 8.2e-6 of |A| @ |B| on
// N(0, 1) data, 38x torch.matmul fp32's 2.2e-7 (chip_smoke.py phase 17 (a)
// on an NVIDIA H100 80GB HBM3 at 700 W; 6.9e-8 with the promotion), and a
// bias on a sum of squares grows with K. Promoting each K-step's partial
// sum to an fp32 add bounds the MMA part of the error by the K-step, as
// cuBLAS's fp32 GEMM is bounded by its own blocking.
//
// Two kernels; ops/matmul.py::launch_plan picks one by the output's width
// before the launch (neither is a fallback for the other). Both read A
// through TMA, so A's base must be 16-byte aligned and its row stride a
// multiple of 16 bytes; the wrapper copies an operand that is not so into a
// padded buffer first, and the Nystrom tier lays its own buffers out so.
//
// gemm_3xtf32_wgmma_kernel, for outputs wider than 16 columns: the
// Nystrom panel, RPCholesky and predict products.
//   * 128 x 128 output tiles (128 x 64 for outputs at most 64 columns
//     wide: the RPCholesky residual and update), K-steps of 32, 384
//     threads: two consumer warpgroups (m64 rows each) and one producer
//     warpgroup, whose first thread issues every copy; setmaxnreg gives
//     the consumers 232 registers a thread and the producer 40;
//   * TMA (cp.async.bulk.tensor, tensor maps encoded on the host and
//     passed as __grid_constant__ parameters, so a CUDA graph captures
//     them by value) copies each raw fp32 A and B tile in its global
//     layout, as boxes of 32 x 128-byte rows with the 128-byte swizzle,
//     into a ring of 4 stages with full / empty mbarriers; the ragged
//     edges are zero-filled by TMA itself;
//   * wgmma on .tf32 reads only K-major operands from shared memory, so B
//     is split by the consumers: once a stage, each of the 256 threads
//     reads a 4 x 4 block of the raw B tile (transposing it when B is
//     stored K x N), writes its big and small parts into two K-major,
//     128-byte swizzled tiles (double buffered), fences the generic-proxy
//     stores for the async proxy (fence.proxy.async) and meets the other
//     warpgroup at a named barrier;
//   * A is split in registers: each thread loads its m16n8k8 A fragment
//     (4 values a k8 slice) from the raw tile and issues the register-A
//     form of wgmma.mma_async.m64nNk8.f32.tf32.tf32, 3 a k8 slice, 12 a
//     K-step, into the partial sum (the first with scale-d = 0); each k8
//     slice's A is loaded and split just before its three wgmmas, and each
//     consumer warp frees the stage after its chain's last A load;
//   * the next stage's split pass runs while this K-step's chain is in
//     flight; then wgmma.wait_group 0, the partial is added to the running
//     sum, and the next chain is issued. One register set for A: with two
//     (the next step's A split ahead of the wait) the consumers needed more
//     than their 232 registers and spilled 388-472 bytes (ptxas);
//   * a persistent grid, one block a SM, walks the work items (tile, K
//     split) in order, the ring running on from one item to the next, so
//     the producer fills the next item's stages during this one's
//     epilogue (at the panel psi = K_pm W 1.38-1.40 ms against 1.42-1.44
//     with a block a tile; equal within the noise at the other shapes:
//     cli/gemm_bench.py on an NVIDIA H100 80GB HBM3 at 700 W);
//   * when the output has fewer tiles than the card has SMs, the K range
//     is split: each split writes its partial tile into a workspace, and
//     the last split of a tile to finish (an atomic count per tile) sums
//     the partials in split order, so the result does not depend on which
//     split finished last; the epilogue writes alpha * acc + beta * C
//     element by element, masked; beta = 0 never reads C.
//
// gemm_3xtf32_narrow_kernel, for outputs at most 16 columns wide (b +=
// psi^T y, the predict's mean): A streamed once is the whole cost, so the
// design is about bytes in flight, not the tensor cores.
//   * a block owns R = 32, 64 or 128 output rows; its 256 consumer threads
//     (8 warps) take a row each and, of every stage's 256 / R K-steps, one;
//     one producer warp, whose first thread issues TMA copies of A into a
//     ring of 5 stages of 32 KB (160 KB in flight a SM): 256 / R boxes
//     {32 K, R rows} with the 128-byte swizzle when A is stored M x K (a
//     thread's 16-byte reads of its row land on 8 distinct chunks a
//     quarter warp), one plain box {R rows, 32 x 256 / R K} when A is
//     stored K x M (a warp reads 32 consecutive floats);
//   * the products run on the CUDA cores: each A element is split once and
//     its three products with the pre-split B (small terms first) are
//     fused multiply-adds, exact products rounded once into the partial.
//     At one output column the TMA stream alone (-DNARROW_ABLATE=1) takes
//     0.0466-0.0474 / 0.0230-0.0235 ms at b += psi^T y / the predict's
//     mean, the whole kernel 0.0486-0.0491 / 0.0246-0.0248: all of the
//     arithmetic costs 4-7%, the most that mma.sync (B padded to 8
//     columns, the same split of A) could win, so the CUDA cores stay.
//     Eight consumer warps, against four: 0.0486 / 0.0247 ms against
//     0.0490 / 0.0257; two or four interleaved FMA chains a K-step gained
//     nothing with eight (cli/gemm_bench.py, an NVIDIA H100 80GB HBM3 at
//     700 W). A's tensor map asks for no L2 promotion: at b += psi^T y a
//     256-byte promotion fetched the neighbouring row block's half of
//     each 256 bytes again (0.0487-0.0489 ms against 0.0468-0.0479);
//   * B (at most 16 columns, padded to NB = 1, 4 or 16) is split once a K
//     chunk by the consumers into (big, small) pairs in shared memory, 32 KB
//     a chunk, read as broadcasts;
//   * split K within a thread block cluster: the S <= 8 blocks of a cluster
//     take the S K ranges of the same R rows; each block sums its slots'
//     partials of a row in slot order, parks the row sums in its shared
//     memory, and after a cluster barrier each block adds its share of the
//     rows over the S blocks in split order through distributed shared
//     memory (mapa + ld.shared::cluster), so the sum is deterministic and
//     needs no workspace, no counters and no second pass;
//   * the grid is sized from the occupancy API (cudaOccupancyMaxActive
//     Clusters, queried once at setup: an H100 holds 132 single blocks, 66
//     clusters of 2, 30 of 4, 15 of 8 of this kernel), and launch_plan
//     picks R and S for the least work on the busiest block: a launch fills
//     the card in one wave, and when the row blocks outnumber the resident
//     clusters each cluster walks several;
//   * alpha * acc + beta * C as above; beta = 0 never reads C.
//
// Every entry point launches once on the given stream, allocates nothing
// (the wgmma wrapper passes the split workspace and the zeroed counters; the
// narrow kernel needs neither) and returns cudaGetLastError(), so it can be
// captured in a CUDA graph. gemm_3xtf32_setup() raises the kernels' dynamic
// shared-memory limit, resolves the driver's cuTensorMapEncodeTiled
// (cudaGetDriverEntryPoint: the library needs no -lcuda) and reads the
// narrow kernel's resident clusters; the wrapper calls it once, when the
// library is loaded.
//
// Built with gram.cu into one library with its flags (ops/_build.py).
// Their -fmad=false touches only the fp32 epilogue here: alpha * acc +
// beta * C rounds each operation, as the plain twin does (the narrow
// kernel's products are explicit fmaf).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;  // K-step

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// big = rna_tf32(x), small = rna_tf32(x - big); x - big is exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

// C[r, c] = alpha v + beta C[r, c] at an element inside the output; beta =
// 0 never reads C. Both kernels' epilogues.
template <class P>
__device__ __forceinline__ void store_out(const P& p, int r, int c, float v) {
  float* out = p.c + static_cast<long long>(r) * p.ldc + c;
  float x = p.alpha * v;
  if (p.beta != 0.0f) x += p.beta * *out;
  *out = x;
}

// The sum of element (r, c)'s partials over the K splits, in split order.
template <class P>
__device__ __forceinline__ float split_sum(const P& p, int r, int c,
                                           int splits) {
  const long long slab = static_cast<long long>(p.m) * p.n;
  const float* w = p.work + static_cast<long long>(r) * p.n + c;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += __ldcg(w + s * slab);
  return sum;
}

// ------------------------------------------------- the Hopper design
namespace hopper {

constexpr int BM = 128;               // output tile rows: two m64 warpgroups
constexpr int STAGES = 4;             // raw A / B tiles in flight
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int BOX = 32;               // fp32 in one 128-byte swizzle row
constexpr int BOX_BYTES = BOX * BK * 4;   // a 32 x 32 box, 4 KB
constexpr int SPLIT_BAR = 1;          // named barriers (0 is __syncthreads)
constexpr int EPILOGUE_BAR = 2;
// -DGEMM_ABLATE=1 leaves out the split pass, 2 two of the three wgmmas a
// k8 slice (big_a big_b alone: a 1xTF32 product through the same
// pipeline). Wrong results: for timing which part holds the kernel back
// (cli/gemm_bench.py --ablate).
#ifndef GEMM_ABLATE
#define GEMM_ABLATE 0
#endif
constexpr int EMPTY_ARRIVALS = CONSUMERS / 32;  // each consumer warp

static_assert(BK == BOX, "a K-step is one 128-byte swizzle row");

// Shared memory of one block, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): STAGES x (raw A, raw B),
// then two buffers of (B_big, B_small), then the mbarriers.
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SPLIT_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = SPLIT_OFF + 4 * B_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 16 + 1024;
  static constexpr int ACC = BN / 2;  // accumulator floats a thread
  static constexpr int SPLIT_BLOCKS = BN * BK / 16;  // 4 x 4 blocks of B
};

// Byte offset of element (r, k) of a tile stored as [rows][32 k], k
// contiguous, 128-byte swizzled: the 16-byte chunk k / 4 of row r lands at
// chunk (k / 4) ^ (r % 8) of its 128-byte row. This is TMA's
// CU_TENSOR_MAP_SWIZZLE_128B layout of a box {32, rows} and the K-major
// layout that a wgmma descriptor with the 128-byte swizzle names.
__device__ __forceinline__ uint32_t kmajor_off(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

// Byte offset of element (r, k) of a tile stored as r / 32 boxes of
// [32 k][32 r], r contiguous (TMA boxes {32, 32} of an operand stored with
// its M or N dimension contiguous), each 128-byte swizzled.
__device__ __forceinline__ uint32_t mnmajor_off(int r, int k) {
  return (r >> 5) * BOX_BYTES + k * 128 + (((((r & 31) >> 2) ^ k) & 7) << 4) +
         ((r & 3) << 2);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait for the phase of `bar` with this parity to complete. The spin has
// no time-out: a trap in this loop makes ptxas serialize the wgmma chains
// (its advisory C7518).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One TMA box {32, rows} at (c0, c1) (innermost coordinate first) into
// shared memory; its bytes complete the transaction count of `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses above the wait nor reuse them before it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void keep(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte swizzled tile at
// shared address `addr`: start address >> 4, leading byte offset 1 (unused
// with this swizzle), stride byte offset 1024 >> 4 (from one group of 8
// rows to the next), swizzle mode 1 (128 bytes). A k8 slice of the tile
// starts 32 bytes further along its rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// partial (+)= a @ B[:, k8] for one m64n128k8 tf32 step, A from registers
// (the m16n8k8 A fragment of each warp), B from the K-major 128-byte
// swizzled tile that `desc` names; scale_d = 0 overwrites the partial.
template <int ScaleD>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(ScaleD));
}

// partial (+)= a @ B[:, k8] for one m64n64k8 tf32 step, A from registers
// (the m16n8k8 A fragment of each warp), B from the K-major 128-byte
// swizzled tile that `desc` names; scale_d = 0 overwrites the partial.
template <int ScaleD>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(ScaleD));
}


template <int BN>
struct Mma;
template <>
struct Mma<128> {
  template <int ScaleD>
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_n128<ScaleD>(d, a, desc);
  }
};
template <>
struct Mma<64> {
  template <int ScaleD>
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_n64<ScaleD>(d, a, desc);
  }
};

// Split four values and store their big and small parts as one 16-byte
// chunk each.
__device__ __forceinline__ void store_split(uint8_t* big, uint8_t* small,
                                            float x0, float x1, float x2,
                                            float x3) {
  uint4 b, s;
  split_tf32(x0, b.x, s.x);
  split_tf32(x1, b.y, s.y);
  split_tf32(x2, b.z, s.z);
  split_tf32(x3, b.w, s.w);
  *reinterpret_cast<uint4*>(big) = b;
  *reinterpret_cast<uint4*>(small) = s;
}

// The split pass over one stage's raw B tile (BN x 32 of op(B)^T): the
// consumer thread `ctid` takes the 4 x 4 block (n 4 nb.., k 4 kb..) and
// writes its big and small parts into the K-major swizzled B_big /
// B_small tiles. The (nb, kb) map puts the 8 threads of each quarter warp
// (one 16-byte access phase) on 8 distinct chunks of a 128-byte row, in
// the reads and in the stores, for either layout of the raw tile
// (tests/test_torch_matmul_wgmma.py models it).
template <int BN, bool TB>
__device__ __forceinline__ void split_b(const uint8_t* raw, uint8_t* big,
                                        uint8_t* small, int ctid) {
  if (GEMM_ABLATE == 1) return;
  if (Tile<BN>::SPLIT_BLOCKS < CONSUMERS && ctid >= Tile<BN>::SPLIT_BLOCKS)
    return;
  const int q = ctid & 7;
  const int nb = (ctid >> 5) * 4 + (q & 3);
  const int kb = (((ctid >> 4) & 1) << 2) | ((((q >> 1) ^ (ctid >> 3)) & 1) << 1) |
                 (q >> 2);
  if constexpr (TB) {  // raw B stored N x K: already K-major
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = kmajor_off(4 * nb + i, 4 * kb);
      const float4 v = *reinterpret_cast<const float4*>(raw + off);
      store_split(big + off, small + off, v.x, v.y, v.z, v.w);
    }
  } else {  // raw B stored K x N: transpose the block in registers
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = *reinterpret_cast<const float4*>(raw +
                                              mnmajor_off(4 * nb, 4 * kb + j));
    store_split(big + kmajor_off(4 * nb, 4 * kb),
                small + kmajor_off(4 * nb, 4 * kb), v[0].x, v[1].x, v[2].x,
                v[3].x);
    store_split(big + kmajor_off(4 * nb + 1, 4 * kb),
                small + kmajor_off(4 * nb + 1, 4 * kb), v[0].y, v[1].y,
                v[2].y, v[3].y);
    store_split(big + kmajor_off(4 * nb + 2, 4 * kb),
                small + kmajor_off(4 * nb + 2, 4 * kb), v[0].z, v[1].z,
                v[2].z, v[3].z);
    store_split(big + kmajor_off(4 * nb + 3, 4 * kb),
                small + kmajor_off(4 * nb + 3, 4 * kb), v[0].w, v[1].w,
                v[2].w, v[3].w);
  }
}

// A thread's A fragments for one K-step, split: for each k8 slice kk, the
// m16n8k8 TF32 A fragment of its warp's 16 rows (value v at row m0 + 8 (v
// & 1), column 8 kk + t + 4 (v >> 1)); m0 = the warpgroup's first row + 16
// warp + lane / 4, t = lane % 4.
template <bool TA>
__device__ __forceinline__ void load_a_slice(const uint8_t* raw, int m0, int t,
                                             int kk, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int m = m0 + 8 * (v & 1), k = 8 * kk + t + 4 * (v >> 1);
    const uint32_t off = TA ? mnmajor_off(m, k) : kmajor_off(m, k);
    split_tf32(*reinterpret_cast<const float*>(raw + off), big[v], small[v]);
  }
}

struct WParams {
  float* c;
  long long ldc;
  int m, n, k;
  float alpha, beta;
  int tiles;       // output tiles
  int splits;      // K splits of each tile
  int k_split;     // K range of one split (a multiple of BK)
  float* work;     // splits x m x n partial sums (splits > 1 only)
  int* counters;   // one zeroed count per output tile (splits > 1)
};

// TA: A stored K x M (else M x K); TB: B stored N x K (else K x N). The
// tensor maps name the stored matrices with boxes of {32, 128} (A, M x K),
// {32, 32} (A, K x M), {32, BN} (B, N x K) or {32, 32} (B, K x N). Each
// block walks the work items (tile, split) from blockIdx.x in steps of
// gridDim.x, the ring and its phases running on from one to the next, so
// the producer fills the next item's stages during this one's epilogue.
template <int BN, bool TA, bool TB>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_3xtf32_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                             const __grid_constant__ CUtensorMap tma_b,
                             WParams p) {
  using T = Tile<BN>;
  constexpr int ACC = T::ACC;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t pad = ((raw_addr + 1023) & ~1023u) - raw_addr;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw_addr + pad;
  const uint32_t full0 = base + T::BAR_OFF;       // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;     // empty[s]
  int* is_last = reinterpret_cast<int*>(smem + T::BAR_OFF + 16 * STAGES);

  const int tid = threadIdx.x;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int items = p.tiles * p.splits;
  // work item w: tile w % tiles, split w / tiles; its K-steps
  auto k_range = [&](int w, int& k0) {
    k0 = (w / p.tiles) * p.k_split;
    const int k1 = min(p.k, k0 + p.k_split);
    return k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx + TMA bytes
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, broadcast from lane 0 so that the compiler sees
  // it uniform across each warp
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == CONSUMERS / 128) {
    // ---- producer warpgroup: its first thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      int g = 0;  // K-steps loaded so far, over the block's work items
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int tile = w % p.tiles;
        const int bm0 = (tile / tiles_n) * BM, bn0 = (tile % tiles_n) * BN;
        int k0;
        const int ktiles = k_range(w, k0);
        for (int j = 0; j < ktiles; ++j, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(empty0 + 8 * s, ((g / STAGES) - 1) & 1);
          const uint32_t bar = full0 + 8 * s;
          mbar_expect_tx(bar, T::STAGE_BYTES);
          const uint32_t dst_a = base + s * T::STAGE_BYTES;
          const uint32_t dst_b = dst_a + T::A_BYTES;
          const int kb = k0 + j * BK;
          if constexpr (TA) {
#pragma unroll
            for (int i = 0; i < BM / BOX; ++i)
              tma_load(dst_a + i * BOX_BYTES, &tma_a, bm0 + i * BOX, kb, bar);
          } else {
            tma_load(dst_a, &tma_a, kb, bm0, bar);
          }
          if constexpr (TB) {
            tma_load(dst_b, &tma_b, kb, bn0, bar);
          } else {
#pragma unroll
            for (int i = 0; i < BN / BOX; ++i)
              tma_load(dst_b + i * BOX_BYTES, &tma_b, bn0 + i * BOX, kb, bar);
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: split, multiply, promote
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = role, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = 64 * wg + 16 * warp + g;
    float acc[ACC], part[ACC];
    uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
    for (int i = 0; i < ACC; ++i) part[i] = 0.0f;

    // Stage j's split pass (j counts K-steps over the block's work items):
    // runs while step j - 1's chain is in flight.
    auto split_stage = [&](int j) {
      const int s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      const int split = T::SPLIT_OFF + (j & 1) * 2 * T::B_BYTES;
      split_b<BN, TB>(smem + s * T::STAGE_BYTES + T::A_BYTES, smem + split,
                      smem + split + T::B_BYTES, tid);
      fence_proxy_async();
    };
    // Wait for the chain in flight and add its partial to the running sum.
    auto promote = [&]() {
      wgmma_wait_all();
      keep(part);
      keep(a_big);
      keep(a_small);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    };
    // Step j's chain, once both warpgroups' split passes are done: each k8
    // slice's A is loaded and split just before its three wgmmas; then the
    // warp frees the stage.
    auto issue = [&](int j) {
      const int s = j % STAGES;
      const uint8_t* raw_a = smem + s * T::STAGE_BYTES;
      const uint32_t big = base + T::SPLIT_OFF + (j & 1) * 2 * T::B_BYTES;
      const uint32_t small = big + T::B_BYTES;
      named_bar_sync(SPLIT_BAR, CONSUMERS);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        load_a_slice<TA>(raw_a, m0, t, kk, a_big[kk], a_small[kk]);
        const uint64_t d_big = sw128_desc(big + 32 * kk);
        const uint64_t d_small = sw128_desc(small + 32 * kk);
        wgmma_fence();
        if (GEMM_ABLATE == 2) {
          if (kk == 0)
            Mma<BN>::template run<0>(part, a_big[kk], d_big);
          else
            Mma<BN>::template run<1>(part, a_big[kk], d_big);
          continue;
        }
        if (kk == 0)
          Mma<BN>::template run<0>(part, a_small[kk], d_big);
        else
          Mma<BN>::template run<1>(part, a_small[kk], d_big);
        Mma<BN>::template run<1>(part, a_big[kk], d_small);
        Mma<BN>::template run<1>(part, a_big[kk], d_big);
      }
      wgmma_commit();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    };

    int steps = 0;  // K-steps consumed so far, over the block's work items
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int tile = w % p.tiles;
      const int bm0 = (tile / tiles_n) * BM, bn0 = (tile % tiles_n) * BN;
      int k0;
      const int ktiles = k_range(w, k0);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
      if (ktiles > 0) {
        split_stage(steps);
        issue(steps);
        for (int j = 1; j < ktiles; ++j) {
          split_stage(steps + j);
          promote();
          issue(steps + j);
        }
        promote();
      }
      steps += ktiles;

      // accumulator element 4 j + e: row m0 (+8 for e >= 2), column 8 j +
      // 2 t (+1 for odd e)
      if (p.splits == 1) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = bm0 + m0 + (e >> 1) * 8;
            const int c = bn0 + 8 * j + 2 * t + (e & 1);
            if (r < p.m && c < p.n) store_out(p, r, c, acc[4 * j + e]);
          }
        continue;
      }

      // split K: park the partial tile, count the split in; the last one
      // in sums the partials in split order and writes C
      const long long slab = static_cast<long long>(p.m) * p.n;
      const int split = w / p.tiles;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = bm0 + m0 + (e >> 1) * 8;
          const int c = bn0 + 8 * j + 2 * t + (e & 1);
          if (r < p.m && c < p.n)
            p.work[split * slab + static_cast<long long>(r) * p.n + c] =
                acc[4 * j + e];
        }
      __threadfence();
      named_bar_sync(EPILOGUE_BAR, CONSUMERS);
      if (tid == 0)
        *is_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
      named_bar_sync(EPILOGUE_BAR, CONSUMERS);
      const int last = __shfl_sync(0xffffffffu, *is_last, 0);
      named_bar_sync(EPILOGUE_BAR, CONSUMERS);  // before the next item's
      if (!last) continue;
      __threadfence();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = bm0 + m0 + (e >> 1) * 8;
          const int c = bn0 + 8 * j + 2 * t + (e & 1);
          if (r < p.m && c < p.n)
            store_out(p, r, c, split_sum(p, r, c, p.splits));
        }
    }
  }
}

template <int BN, bool TA, bool TB>
cudaError_t setup_one() {
  return cudaFuncSetAttribute(gemm_3xtf32_wgmma_kernel<BN, TA, TB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<BN>::SMEM_BYTES);
}

template <int BN, bool TA, bool TB>
void launch_one(const CUtensorMap& ma, const CUtensorMap& mb,
                const WParams& p, int blocks, cudaStream_t stream) {
  gemm_3xtf32_wgmma_kernel<BN, TA, TB>
      <<<blocks, THREADS, Tile<BN>::SMEM_BYTES, stream>>>(ma, mb, p);
}

template <int BN>
void launch_tile(bool ta, bool tb, const CUtensorMap& ma,
                 const CUtensorMap& mb, const WParams& p, int blocks,
                 cudaStream_t stream) {
  if (ta) {
    if (tb)
      launch_one<BN, true, true>(ma, mb, p, blocks, stream);
    else
      launch_one<BN, true, false>(ma, mb, p, blocks, stream);
  } else {
    if (tb)
      launch_one<BN, false, true>(ma, mb, p, blocks, stream);
    else
      launch_one<BN, false, false>(ma, mb, p, blocks, stream);
  }
}

// cuTensorMapEncodeTiled, resolved through the runtime at setup
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

cudaError_t resolve_encode_tiled() {
  if (encode_tiled != nullptr) return cudaSuccess;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return cudaErrorSymbolNotFound;
  encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  return cudaSuccess;
}

// The tensor map of a row-major (rows x cols, row stride ld floats) fp32
// matrix read in boxes of {box_cols, box_rows}, 128-byte swizzled (box_cols
// = 32) or not, the ragged edges zero-filled.
bool encode(CUtensorMap* map, const float* base, int rows, int cols,
            long long ld, int box_rows, int box_cols = BOX,
            bool swizzle = true,
            CUtensorMapL2promotion promotion =
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                      const_cast<float*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE,
                      promotion,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A product with K = 0 reads nothing, but TMA takes no empty matrix: its
// tensor maps name this 16-byte aligned stand-in, as one row of 4 floats.
__device__ __align__(128) float k0_stand_in[4];
const float* k0_base = nullptr;

cudaError_t resolve_k0_base() {
  if (k0_base != nullptr) return cudaSuccess;
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, k0_stand_in);
  k0_base = static_cast<const float*>(p);
  return err;
}

}  // namespace hopper

// ------------------------------------------------- the narrow kernel
namespace narrow {

using hopper::kmajor_off;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_bar_sync;
using hopper::tma_load;

constexpr int CONSUMERS = 256;           // eight warps (ops/matmul.py's
                                         // NARROW_THREADS)
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int STAGE_BYTES = CONSUMERS * BK * 4;  // one K-step a thread
constexpr int RING_BYTES = 163840;       // 160 KB in flight
constexpr int STAGES = RING_BYTES / STAGE_BYTES;
constexpr int B_BYTES = 32768;           // one K chunk of split B
constexpr int B_PER_THREAD = B_BYTES / 8 / CONSUMERS;
constexpr int MAX_CLUSTER = 8;           // K splits of a row block
constexpr int EMPTY_ARRIVALS = CONSUMERS / 32;      // each consumer warp
constexpr int CONSUMER_BAR = 1;          // named barrier (0 is __syncthreads)
// -DNARROW_ABLATE=1 leaves out the arithmetic (the consumers only wait for
// each stage and free it: the stream alone), 2 two of the three products a
// term (big_a big_b alone). Wrong results: for timing what holds the
// kernel back (cli/gemm_bench.py --ablate).
#ifndef NARROW_ABLATE
#define NARROW_ABLATE 0
#endif

// A block of R output rows (32, 64 or 128): consumer thread t takes row
// t % R and, of each stage's Q = CONSUMERS / R K-steps, K-step t / R (its
// slot).
template <int R>
struct Rows {
  static constexpr int Q = CONSUMERS / R;
  static constexpr int STAGE_K = BK * Q;
  static_assert(R * Q == CONSUMERS && R >= 32, "R divides CONSUMERS");
};

// Shared memory of one block, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): STAGES raw A stages, the
// split B chunk as (big, small) pairs [k][NB], the parked partials (a
// thread's NB sums) and the mbarriers.
template <int NB>
struct Smem {
  static constexpr int CHUNK_K = B_BYTES / (8 * NB);
  static constexpr int B_OFF = STAGES * STAGE_BYTES;
  static constexpr int RED_OFF = B_OFF + B_BYTES;
  static constexpr int BAR_OFF = RED_OFF + NB * CONSUMERS * 4;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(CHUNK_K % (BK * CONSUMERS / 32) == 0,
                "a B chunk holds whole stages");
};

struct NParams {
  const float* b;
  long long ldb;
  int trans_b;     // B stored N x K (else K x N)
  float* c;
  long long ldc;
  int m, n, k;
  float alpha, beta;
  int row_blocks;  // ceil(m / R)
  int k_split;     // K range of one split, a multiple of the stage's K
};

__device__ __forceinline__ uint32_t sreg_cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t sreg_cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t sreg_cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t sreg_clusters() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: what each wrote to shared memory before is
// visible to all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The float at this block's shared address `addr`, in block `rank` of the
// cluster.
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// One term a: its three products with B's (big, small) pairs of this k,
// small terms first, each exact and rounded once into the partial.
template <int NB>
__device__ __forceinline__ void term(float (&part)[NB], float a,
                                     const float2* b) {
  if (NARROW_ABLATE == 2) {
#pragma unroll
    for (int j = 0; j < NB; ++j) part[j] = __fmaf_rn(a, b[j].x, part[j]);
    return;
  }
  uint32_t big, small;
  split_tf32(a, big, small);
  const float ab = __uint_as_float(big), as = __uint_as_float(small);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float2 bj = b[j];
    part[j] = __fmaf_rn(as, bj.x, part[j]);
    part[j] = __fmaf_rn(ab, bj.y, part[j]);
    part[j] = __fmaf_rn(ab, bj.x, part[j]);
  }
}

// Split B's rows [c0, c0 + CHUNK_K) (zero past k1 and past column n) into
// (big, small) pairs [k][NB]; every consumer's global loads are issued
// before any is used.
template <int NB>
__device__ __forceinline__ void split_b_chunk(const NParams& p, int c0,
                                              int k1, float2* out, int tid) {
  float v[B_PER_THREAD];
#pragma unroll
  for (int u = 0; u < B_PER_THREAD; ++u) {
    const int i = tid + u * CONSUMERS;
    const int kk = c0 + i / NB, nn = i % NB;
    v[u] = 0.0f;
    if (kk < k1 && nn < p.n)
      v[u] = p.trans_b ? p.b[nn * p.ldb + kk] : p.b[kk * p.ldb + nn];
  }
#pragma unroll
  for (int u = 0; u < B_PER_THREAD; ++u) {
    uint32_t big, small;
    split_tf32(v[u], big, small);
    out[tid + u * CONSUMERS] =
        make_float2(__uint_as_float(big), __uint_as_float(small));
  }
}

// TA: A stored K x M (else M x K). The tensor map names the stored A with
// boxes {R rows, 32 Q K} (TA, no swizzle) or {32 K, R rows} (128-byte
// swizzle, Q of them a stage). Block rank s of a cluster takes K range [s
// k_split, (s + 1) k_split); cluster c walks the row blocks c, c +
// clusters, ...
template <int NB, bool TA, int R>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_3xtf32_narrow_kernel(const __grid_constant__ CUtensorMap tma_a,
                              NParams p) {
  using S = Smem<NB>;
  constexpr int Q = Rows<R>::Q, STAGE_K = Rows<R>::STAGE_K;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t pad = ((raw_addr + 1023) & ~1023u) - raw_addr;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw_addr + pad;
  const uint32_t full0 = base + S::BAR_OFF;       // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;     // empty[s]
  float2* b_split = reinterpret_cast<float2*>(smem + S::B_OFF);
  float* red = reinterpret_cast<float*>(smem + S::RED_OFF);
  const uint32_t red_addr = base + S::RED_OFF;

  const int tid = threadIdx.x, lane = tid & 31;
  const int split = static_cast<int>(sreg_cluster_rank());
  const int splits = static_cast<int>(sreg_cluster_size());
  const int k0 = split * p.k_split;
  const int k1 = min(p.k, k0 + p.k_split);
  const int steps = k1 > k0 ? (k1 - k0 + STAGE_K - 1) / STAGE_K : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx + TMA bytes
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int r = tid % R, q = tid / R;   // a consumer's row and slot
  int g = 0;  // stages so far, over the block's row blocks
  for (int rb = sreg_cluster_id(); rb < p.row_blocks; rb += sreg_clusters()) {
    const int row0 = rb * R;
    if (tid >= CONSUMERS) {
      // ---- producer warp: its first thread keeps the ring full
      if (tid == CONSUMERS) {
        for (int j = 0; j < steps; ++j) {
          const int gj = g + j, s = gj % STAGES;
          if (gj >= STAGES) mbar_wait(empty0 + 8 * s, ((gj / STAGES) - 1) & 1);
          const uint32_t bar = full0 + 8 * s;
          mbar_expect_tx(bar, STAGE_BYTES);
          const uint32_t dst = base + s * STAGE_BYTES;
          const int kb = k0 + j * STAGE_K;
          if constexpr (TA) {
            tma_load(dst, &tma_a, row0, kb, bar);
          } else {
#pragma unroll
            for (int i = 0; i < Q; ++i)
              tma_load(dst + i * R * 128, &tma_a, kb + i * BK, row0, bar);
          }
        }
      }
      __syncwarp();
    } else {
      // ---- consumers: row row0 + r, K-step q of each stage
      float acc[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[j] = 0.0f;
      for (int j = 0; j < steps; ++j) {
        const int kc = (j * STAGE_K) % S::CHUNK_K;  // the stage in its chunk
        if (kc == 0) {
          // split B's next chunk, once every consumer is done with the last
          named_bar_sync(CONSUMER_BAR, CONSUMERS);
          split_b_chunk<NB>(p, k0 + j * STAGE_K, k1, b_split, tid);
          named_bar_sync(CONSUMER_BAR, CONSUMERS);
        }
        const int gj = g + j, s = gj % STAGES;
        mbar_wait(full0 + 8 * s, (gj / STAGES) & 1);
        if (NARROW_ABLATE != 1) {
          const uint8_t* stage = smem + s * STAGE_BYTES;
          const float2* bk = b_split + (kc + q * BK) * NB;
          float part[NB];
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) part[jj] = 0.0f;
          if constexpr (TA) {
            const float* col = reinterpret_cast<const float*>(stage) +
                               q * BK * R + r;
#pragma unroll 8
            for (int kk = 0; kk < BK; ++kk)
              term<NB>(part, col[kk * R], bk + kk * NB);
          } else {
            const uint8_t* box = stage + q * R * 128;
#pragma unroll
            for (int kq = 0; kq < BK / 4; ++kq) {
              const float4 v = *reinterpret_cast<const float4*>(
                  box + kmajor_off(r, 4 * kq));
              term<NB>(part, v.x, bk + (4 * kq) * NB);
              term<NB>(part, v.y, bk + (4 * kq + 1) * NB);
              term<NB>(part, v.z, bk + (4 * kq + 2) * NB);
              term<NB>(part, v.w, bk + (4 * kq + 3) * NB);
            }
          }
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) acc[jj] += part[jj];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
      // the slots' sums of each row, in slot order
#pragma unroll
      for (int j = 0; j < NB; ++j) red[(q * NB + j) * R + r] = acc[j];
      named_bar_sync(CONSUMER_BAR, CONSUMERS);
      if (q == 0) {
        const int row = row0 + r;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float sum = 0.0f;
#pragma unroll
          for (int qq = 0; qq < Q; ++qq) sum += red[(qq * NB + j) * R + r];
          if (splits > 1)
            red[j * R + r] = sum;     // slot 0's own place: parked
          else if (row < p.m && j < p.n)
            store_out(p, row, j, sum);
        }
      }
      named_bar_sync(CONSUMER_BAR, CONSUMERS);  // red read before reuse
    }
    g += steps;
    if (splits > 1) {
      cluster_sync();  // every split's row sums parked
      // this block's share of the rows: the sums added in split order
      const int share = R / splits;
      for (int e = tid; e < share * NB && tid < CONSUMERS; e += CONSUMERS) {
        const int rr = split * share + e % share, nn = e / share;
        const int row = row0 + rr;
        if (row < p.m && nn < p.n) {
          const uint32_t at = red_addr + 4 * (nn * R + rr);
          float sum = 0.0f;
          for (int s = 0; s < splits; ++s) sum += ld_cluster(at, s);
          store_out(p, row, nn, sum);
        }
      }
      cluster_sync();  // the sums read: parked anew, or the block exits
    }
  }
}

template <int NB, bool TA, int R>
cudaError_t setup_one() {
  return cudaFuncSetAttribute(gemm_3xtf32_narrow_kernel<NB, TA, R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<NB>::BYTES);
}

template <int NB>
cudaLaunchConfig_t config(int clusters, int splits, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Smem<NB>::BYTES;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of 1, 2, 4 and 8 blocks the card holds at once, by layout, NB
// and R, read at setup.
int resident[2][3][3][4] = {};

constexpr int nb_index(int nb) { return nb == 1 ? 0 : nb == 4 ? 1 : 2; }
constexpr int r_index(int r) { return r == 32 ? 0 : r == 64 ? 1 : 2; }

template <int NB, bool TA, int R>
cudaError_t count_resident() {
  for (int i = 0; i < 4; ++i) {
    const int splits = 1 << i;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config<NB>(132, splits, nullptr, &attr);
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &resident[TA][nb_index(NB)][r_index(R)][i],
        reinterpret_cast<const void*>(gemm_3xtf32_narrow_kernel<NB, TA, R>),
        &cfg);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int NB, bool TA, int R>
cudaError_t prepare() {
  const cudaError_t err = setup_one<NB, TA, R>();
  return err != cudaSuccess ? err : count_resident<NB, TA, R>();
}

template <bool TA, int R>
cudaError_t prepare_rows() {
  const cudaError_t each[] = {prepare<1, TA, R>(), prepare<4, TA, R>(),
                              prepare<16, TA, R>()};
  for (cudaError_t e : each)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

cudaError_t prepare_all() {
  const cudaError_t each[] = {prepare_rows<false, 32>(),
                              prepare_rows<false, 64>(),
                              prepare_rows<false, 128>(),
                              prepare_rows<true, 32>(),
                              prepare_rows<true, 64>(),
                              prepare_rows<true, 128>()};
  for (cudaError_t e : each)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <int NB, bool TA, int R>
cudaError_t launch_one(const CUtensorMap& ma, const NParams& p, int clusters,
                       int splits, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<NB>(clusters, splits, stream, &attr);
  void* args[] = {const_cast<CUtensorMap*>(&ma),
                  const_cast<NParams*>(&p)};
  return cudaLaunchKernelExC(
      &cfg,
      reinterpret_cast<const void*>(gemm_3xtf32_narrow_kernel<NB, TA, R>),
      args);
}

template <bool TA, int R>
cudaError_t launch_rows(int nb, const CUtensorMap& ma, const NParams& p,
                        int clusters, int splits, cudaStream_t stream) {
  if (nb == 1) return launch_one<1, TA, R>(ma, p, clusters, splits, stream);
  if (nb == 4) return launch_one<4, TA, R>(ma, p, clusters, splits, stream);
  return launch_one<16, TA, R>(ma, p, clusters, splits, stream);
}

template <bool TA>
cudaError_t launch_layout(int rows, int nb, const CUtensorMap& ma,
                          const NParams& p, int clusters, int splits,
                          cudaStream_t stream) {
  if (rows == 32)
    return launch_rows<TA, 32>(nb, ma, p, clusters, splits, stream);
  if (rows == 64)
    return launch_rows<TA, 64>(nb, ma, p, clusters, splits, stream);
  return launch_rows<TA, 128>(nb, ma, p, clusters, splits, stream);
}

}  // namespace narrow

}  // namespace

extern "C" {

int gemm_3xtf32_setup() {
  cudaError_t err = cudaSuccess;
  const cudaError_t each[] = {
      hopper::setup_one<128, false, false>(),
      hopper::setup_one<128, false, true>(),
      hopper::setup_one<128, true, false>(),
      hopper::setup_one<128, true, true>(),
      hopper::setup_one<64, false, false>(),
      hopper::setup_one<64, false, true>(),
      hopper::setup_one<64, true, false>(),
      hopper::setup_one<64, true, true>(),
      narrow::prepare_all(),
      hopper::resolve_encode_tiled(),
      hopper::resolve_k0_base()};
  for (cudaError_t e : each)
    if (e != cudaSuccess && err == cudaSuccess) err = e;
  return static_cast<int>(err);
}

// The product on the Hopper design: C (m x n, row stride ldc) = alpha
// op(A) op(B) + beta C. trans_a: A is stored k x m (else m x k), trans_b: B
// is stored n x k (else k x n), each row-major with a 16-byte aligned base
// and a row stride (lda, ldb) that is a multiple of 4 floats and at least
// its stored column count (the wrapper passes any such stride for an
// operand with one stored row); m, n >= 1. n64: the 128 x 64 tile (else
// 128 x 128). tiles: the output tiles; splits: K splits of k_split each
// (work: splits * m * n floats and counters: tiles zeroed ints when splits
// > 1, else unused). blocks: the persistent grid, at most one block a SM,
// walking the tiles * splits work items. A tensor map the driver refuses
// returns cudaErrorInvalidValue, before any launch.
int gemm_3xtf32_wgmma(int trans_a, int trans_b, int n64, int m, int n, int k,
                      float alpha, const float* a, long long lda,
                      const float* b, long long ldb, float beta, float* c,
                      long long ldc, int tiles, int splits, int k_split,
                      int blocks, float* work, int* counters, void* stream) {
  if (hopper::encode_tiled == nullptr || hopper::k0_base == nullptr)
    return static_cast<int>(cudaErrorInitializationError);
  CUtensorMap ma, mb;
  const int bn = n64 ? 64 : 128;
  bool ok;
  if (k == 0) {
    ok = hopper::encode(&ma, hopper::k0_base, 1, 4, 4, hopper::BM) &&
         hopper::encode(&mb, hopper::k0_base, 1, 4, 4, bn);
  } else {
    ok = (trans_a ? hopper::encode(&ma, a, k, m, lda, hopper::BOX)
                  : hopper::encode(&ma, a, m, k, lda, hopper::BM)) &&
         (trans_b ? hopper::encode(&mb, b, n, k, ldb, bn)
                  : hopper::encode(&mb, b, k, n, ldb, hopper::BOX));
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const hopper::WParams p{c,     ldc,    m,       n,    k,       alpha,
                          beta,  tiles,  splits,  k_split, work, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n64)
    hopper::launch_tile<64>(trans_a, trans_b, ma, mb, p, blocks, s);
  else
    hopper::launch_tile<128>(trans_a, trans_b, ma, mb, p, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `splits` blocks (1, 2, 4 or 8) of the narrow kernel that the
// card holds at once, for A stored transposed (trans_a) or not, B padded
// to nb columns (1, 4 or 16) and blocks of `rows` output rows (32, 64 or
// 128); -1 for another argument.
int gemm_3xtf32_narrow_clusters(int trans_a, int nb, int rows, int splits) {
  const int s_index = splits == 1 ? 0 : splits == 2 ? 1 : splits == 4 ? 2
                      : splits == 8 ? 3 : -1;
  if ((nb != 1 && nb != 4 && nb != 16) ||
      (rows != 32 && rows != 64 && rows != 128) || s_index < 0)
    return -1;
  return narrow::resident[trans_a ? 1 : 0][narrow::nb_index(nb)]
                         [narrow::r_index(rows)][s_index];
}

// The product on the narrow kernel, for n <= 16: operands as above, except
// that B is read element by element (any row stride ldb) and only A needs
// a TMA-addressable layout; m, n >= 1. nb: B's columns padded to 1, 4 or
// 16 (>= n). rows: a block's output rows (32, 64 or 128; each stage holds
// 256 / rows K-steps); row_blocks: ceil(m / rows). splits: the cluster
// size, K splits of k_split each (a multiple of 32 * 256 / rows);
// clusters: the grid's clusters, each walking the row blocks from its
// index in steps of their count.
int gemm_3xtf32_narrow(int trans_a, int trans_b, int nb, int rows, int m,
                       int n, int k, float alpha, const float* a,
                       long long lda, const float* b, long long ldb,
                       float beta, float* c, long long ldc, int row_blocks,
                       int splits, int k_split, int clusters, void* stream) {
  if (hopper::encode_tiled == nullptr || hopper::k0_base == nullptr)
    return static_cast<int>(cudaErrorInitializationError);
  if (n > nb || (nb != 1 && nb != 4 && nb != 16) ||
      (rows != 32 && rows != 64 && rows != 128) || splits < 1 ||
      splits > narrow::MAX_CLUSTER ||
      k_split % (BK * narrow::CONSUMERS / rows) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma;
  bool ok;
  if (k == 0)
    ok = hopper::encode(&ma, hopper::k0_base, 1, 4, 4, rows);
  else if (trans_a)
    ok = hopper::encode(&ma, a, k, m, lda, BK * narrow::CONSUMERS / rows,
                        rows, false, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  else
    ok = hopper::encode(&ma, a, m, k, lda, rows, hopper::BOX, true,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const narrow::NParams p{b,     ldb,  trans_b, c,          ldc,    m,
                          n,     k,    alpha,   beta,       row_blocks,
                          k_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      trans_a ? narrow::launch_layout<true>(rows, nb, ma, p, clusters,
                                            splits, s)
              : narrow::launch_layout<false>(rows, nb, ma, p, clusters,
                                             splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
