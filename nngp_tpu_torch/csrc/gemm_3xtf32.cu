// 3xTF32 tensor-core GEMM for Hopper (sm_90a), bound to Python with ctypes:
//
//     C = alpha * op(A) @ op(B) + beta * C        (fp32 in, fp32 out)
//
// op is the identity or the transpose, read from the strides by the wrapper
// (nngp_tpu_torch/ops/matmul.py). It is what precision='high' runs on the
// card in the Nystrom tier (gp/nystrom.py): the panel moments psi = K_pm W,
// C += psi^T psi, b += psi^T y, M1 += psi_K^T psi, the RPCholesky residual
// g = K - F F_S^T and update F_new = g[:, perm] L^-T, and the predict's
// projections.
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
// The TF32 lives inside this kernel's instructions: the global TF32
// switches that utils/device.py turns off are never touched.
//
// What bounds it on this card. The FLOPs: 3 * 2 M N K on the TF32 tensor
// cores (495 TFLOP/s dense on an H100 SXM), against the bytes (each operand
// read once, C written once and read once when beta != 0) at 3.35 TB/s. The
// Nystrom panel (16,384 x 2,048) @ (2,048 x 2,048) is 412 GFLOP of 3xTF32
// work, 0.83 ms, against 285 MB, 0.085 ms: compute-bound. A product with
// one output column (b += psi^T y, the predict's mean) is bytes-bound.
//
// The design, right and simple first (wgmma with TMA is later work):
//   * 128 x 64 block tiles (8 warps, 32 x 32 each; the RPCholesky residual
//     is 64 columns wide) and 128 x 16 tiles for outputs at most 16
//     columns wide (8 warps, 16 x 16 each), K-steps of 32;
//   * A and B tiles staged into shared memory by cp.async, double buffered
//     (the next K-step's copies fly while this one computes). Each tile is
//     kept in its global layout (the contiguous dimension stays contiguous)
//     with a row padding that makes the fragment reads free of bank
//     conflicts in all four layouts; 16-byte copies where the operand's
//     base and row stride allow them, 4-byte ones otherwise; the ragged
//     edges are zero-filled by the copy itself;
//   * the fragments are split into big and small parts in registers, and
//     three mma.sync.m16n8k8 TF32 instructions per fragment pair, the small
//     terms first, accumulate a K-step's 32 terms into a zeroed fp32
//     fragment, which is then added to the running sum with an fp32 FADD.
//     The tensor cores do not round their sums to nearest: with the whole
//     K range in the MMA's own accumulator, the error against fp64 at the
//     Nystrom panel's C += psi^T psi (K = 16,384) was 8.2e-6 of |A| @ |B|
//     on N(0, 1) data, 38x torch.matmul fp32's 2.2e-7 (chip_smoke.py phase
//     17 (a) on an NVIDIA H100 80GB HBM3 at 700 W; 6.9e-8 with the
//     promotion), and a bias on a sum of squares grows with K. Promoting each
//     K-step's partial sum to an fp32 add bounds the MMA part of the error
//     by the K-step, as cuBLAS's fp32 GEMM is bounded by its own blocking;
//   * when the output has fewer tiles than the card has SMs (the products
//     with one output column, the predict's small buckets), the K range is
//     split over blockIdx.y: each split writes its partial tile into a
//     workspace, and the last split of a tile to finish (an atomic count
//     per tile) sums the partials in split order, so the result does not
//     depend on which split finished last;
//   * the epilogue writes alpha * acc + beta * C element by element, masked;
//     beta = 0 never reads C.
//
// Every entry point launches once on the given stream, allocates nothing
// (the wrapper passes the split workspace and the zeroed counters) and
// returns cudaGetLastError(), so it can be captured in a CUDA graph.
// gemm_3xtf32_setup() raises the kernels' dynamic shared-memory limit; the
// wrapper calls it once, when the library is loaded.
//
// Built with gram.cu into one library with its flags (ops/_build.py).
// Their -fmad=false touches only the fp32 epilogue here: alpha * acc +
// beta * C rounds each operation, as the plain twin does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;  // K-step

struct Params {
  const float* a;
  const float* b;
  float* c;
  long long lda, ldb, ldc;
  int m, n, k;
  float alpha, beta;
  int vec_a, vec_b;      // 16-byte copies allowed for A / B
  int k_split;           // K range of one split (a multiple of BK)
  float* work;           // splits x m x n partial sums (gridDim.y > 1 only)
  int* counters;         // one zeroed count per output tile (gridDim.y > 1)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with a source size: the bytes past `src_bytes` are zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy the TR x TC tile at (r0, c0) of a row-major (rows x cols, row stride
// ld) matrix into shared memory with row stride LDS, zero-filling what lies
// outside the matrix.
template <int TR, int TC, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long ld, int rows, int cols,
                                          int r0, int c0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CH = TC / 4, TOTAL = TR * CH;
#pragma unroll
    for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
      const int i = it * THREADS + tid;
      if (TOTAL % THREADS == 0 || i < TOTAL) {
        const int r = i / CH, c = (i % CH) * 4;
        const int gr = r0 + r, gc = c0 + c;
        const float* src = g;
        int bytes = 0;
        if (gr < rows && gc < cols) {
          src = g + static_cast<long long>(gr) * ld + gc;
          bytes = 4 * min(4, cols - gc);
        }
        cp_async16(s + r * LDS + c, src, bytes);
      }
    }
  } else {
    constexpr int TOTAL = TR * TC;
#pragma unroll 4
    for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
      const int i = it * THREADS + tid;
      if (TOTAL % THREADS == 0 || i < TOTAL) {
        const int r = i / TC, c = i % TC;
        const int gr = r0 + r, gc = c0 + c;
        const bool in = gr < rows && gc < cols;
        cp_async4(s + r * LDS + c,
                  in ? g + static_cast<long long>(gr) * ld + gc : g,
                  in ? 4 : 0);
      }
    }
  }
}

// Block tile BM x BN, warp tile WM x WN; TA / TB: A / B stored transposed
// (A as K x M, B as N x K, row-major).
template <int BM, int BN, int WM, int WN, bool TA, bool TB>
struct Cfg {
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // shared tiles keep the global layout: A as [BM][BK + 4] (k contiguous)
  // or [BK][BM + 8] (m contiguous), B as [BK][BN + 8] or [BN][BK + 4].
  // A row stride of 4 mod 32 words (k contiguous) or 8 mod 32 (m or n
  // contiguous) puts the 32 lanes of a fragment read on 32 banks.
  static constexpr int LDA = TA ? BM + 8 : BK + 4;
  static constexpr int A_TILE = TA ? BK * LDA : BM * LDA;
  static constexpr int LDB = TB ? BK + 4 : BN + 8;
  static constexpr int B_TILE = TB ? BN * LDB : BK * LDB;
  static constexpr int STAGE = A_TILE + B_TILE;
  static constexpr int SMEM_BYTES = 2 * STAGE * static_cast<int>(sizeof(float));
};

template <int BM, int BN, int WM, int WN, bool TA, bool TB>
__global__ void __launch_bounds__(Cfg<BM, BN, WM, WN, TA, TB>::THREADS, 2)
    gemm_3xtf32_kernel(Params p) {
  using C = Cfg<BM, BN, WM, WN, TA, TB>;
  constexpr int MT = C::MT, NT = C::NT, THREADS = C::THREADS;
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp % C::WARPS_M) * WM;
  const int wn0 = (warp / C::WARPS_M) * WN;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int bm0 = (tile / tiles_n) * BM, bn0 = (tile % tiles_n) * BN;
  const int k0 = blockIdx.y * p.k_split;
  const int k1 = min(p.k, k0 + p.k_split);
  const int ktiles = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // K steps end at a multiple of BK past k0, and k_split is a multiple of
  // BK, so masking at p.k alone keeps each split inside its range.
  auto load_stage = [&](int stage, int kb) {
    float* sa = smem + stage * C::STAGE;
    float* sb = sa + C::A_TILE;
    if constexpr (TA)
      load_tile<BK, BM, C::LDA, THREADS>(sa, p.a, p.lda, p.k, p.m, kb, bm0,
                                         p.vec_a);
    else
      load_tile<BM, BK, C::LDA, THREADS>(sa, p.a, p.lda, p.m, p.k, bm0, kb,
                                         p.vec_a);
    if constexpr (TB)
      load_tile<BN, BK, C::LDB, THREADS>(sb, p.b, p.ldb, p.n, p.k, bn0, kb,
                                         p.vec_b);
    else
      load_tile<BK, BN, C::LDB, THREADS>(sb, p.b, p.ldb, p.k, p.n, kb, bn0,
                                         p.vec_b);
    cp_async_commit();
  };
  auto a_at = [&](const float* sa, int m, int k) {
    return TA ? sa[k * C::LDA + m] : sa[m * C::LDA + k];
  };
  auto b_at = [&](const float* sb, int k, int n) {
    return TB ? sb[n * C::LDB + k] : sb[k * C::LDB + n];
  };

  if (ktiles > 0) load_stage(0, k0);
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      load_stage((kt + 1) & 1, k0 + (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sa = smem + (kt & 1) * C::STAGE;
    const float* sb = sa + C::A_TILE;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nn = wn0 + j * 8 + g;
        split_tf32(b_at(sb, kk + t, nn), b_big[j][0], b_small[j][0]);
        split_tf32(b_at(sb, kk + t + 4, nn), b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mm = wm0 + i * 16 + g;
        uint32_t a_big[4], a_small[4];
        split_tf32(a_at(sa, mm, kk + t), a_big[0], a_small[0]);
        split_tf32(a_at(sa, mm + 8, kk + t), a_big[1], a_small[1]);
        split_tf32(a_at(sa, mm, kk + t + 4), a_big[2], a_small[2]);
        split_tf32(a_at(sa, mm + 8, kk + t + 4), a_big[3], a_small[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_tf32(part[i][j], a_small, b_big[j]);
          mma_tf32(part[i][j], a_big, b_small[j]);
          mma_tf32(part[i][j], a_big, b_big[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    __syncthreads();
  }

  // accumulator element e of fragment (i, j): row g (+8 for e >= 2),
  // column 2 t (+1 for odd e)
  if (gridDim.y == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = bm0 + wm0 + i * 16 + g + (e >> 1) * 8;
          const int c = bn0 + wn0 + j * 8 + 2 * t + (e & 1);
          if (r < p.m && c < p.n) {
            float* out = p.c + static_cast<long long>(r) * p.ldc + c;
            float v = p.alpha * acc[i][j][e];
            if (p.beta != 0.0f) v += p.beta * *out;
            *out = v;
          }
        }
    return;
  }

  // split K: park the partial tile, count the split in; the last one in
  // sums the partials in split order and writes C
  const long long slab = static_cast<long long>(p.m) * p.n;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = bm0 + wm0 + i * 16 + g + (e >> 1) * 8;
        const int c = bn0 + wn0 + j * 8 + 2 * t + (e & 1);
        if (r < p.m && c < p.n)
          p.work[blockIdx.y * slab + static_cast<long long>(r) * p.n + c] =
              acc[i][j][e];
      }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(p.counters + tile, 1) ==
              static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = bm0 + wm0 + i * 16 + g + (e >> 1) * 8;
        const int c = bn0 + wn0 + j * 8 + 2 * t + (e & 1);
        if (r < p.m && c < p.n) {
          const float* w = p.work + static_cast<long long>(r) * p.n + c;
          float sum = 0.0f;
          for (unsigned s = 0; s < gridDim.y; ++s) sum += __ldcg(w + s * slab);
          float* out = p.c + static_cast<long long>(r) * p.ldc + c;
          float v = p.alpha * sum;
          if (p.beta != 0.0f) v += p.beta * *out;
          *out = v;
        }
      }
}

// the two tile shapes, wide (128 x 64) and narrow (128 x 16, for outputs
// at most 16 columns wide); ops/matmul.py::TILES mirrors them
template <bool TA, bool TB, bool NARROW>
struct Shape {
  static constexpr int BM = 128, BN = NARROW ? 16 : 64;
  static constexpr int WM = NARROW ? 16 : 32, WN = NARROW ? 16 : 32;
  using C = Cfg<BM, BN, WM, WN, TA, TB>;
};

template <bool TA, bool TB, bool NARROW>
cudaError_t setup_one() {
  using S = Shape<TA, TB, NARROW>;
  return cudaFuncSetAttribute(
      gemm_3xtf32_kernel<S::BM, S::BN, S::WM, S::WN, TA, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::C::SMEM_BYTES);
}

template <bool TA, bool TB, bool NARROW>
void launch_one(const Params& p, int tiles, int splits, cudaStream_t stream) {
  using S = Shape<TA, TB, NARROW>;
  gemm_3xtf32_kernel<S::BM, S::BN, S::WM, S::WN, TA, TB>
      <<<dim3(tiles, splits), S::C::THREADS, S::C::SMEM_BYTES, stream>>>(p);
}

template <bool TA, bool TB>
void launch_layout(bool narrow, const Params& p, int tiles, int splits,
                   cudaStream_t stream) {
  if (narrow)
    launch_one<TA, TB, true>(p, tiles, splits, stream);
  else
    launch_one<TA, TB, false>(p, tiles, splits, stream);
}

}  // namespace

extern "C" {

int gemm_3xtf32_setup() {
  cudaError_t err = cudaSuccess;
  const cudaError_t each[] = {
      setup_one<false, false, false>(), setup_one<false, true, false>(),
      setup_one<true, false, false>(),  setup_one<true, true, false>(),
      setup_one<false, false, true>(),  setup_one<false, true, true>(),
      setup_one<true, false, true>(),   setup_one<true, true, true>()};
  for (cudaError_t e : each)
    if (e != cudaSuccess && err == cudaSuccess) err = e;
  return static_cast<int>(err);
}

// C (m x n, row stride ldc) = alpha op(A) op(B) + beta C. trans_a: A is
// stored k x m (else m x k), trans_b: B is stored n x k (else k x n), each
// row-major with its row stride. vec_a / vec_b: the operand's base is 16-byte
// aligned and its row stride a multiple of 4 (or it has one stored row).
// narrow: the 128 x 16 tile. tiles: the output tiles of that shape;
// splits: K splits of k_split each (work: splits * m * n floats and
// counters: tiles zeroed ints when splits > 1, else unused).
int gemm_3xtf32(int trans_a, int trans_b, int narrow, int m, int n, int k,
                float alpha, const float* a, long long lda, int vec_a,
                const float* b, long long ldb, int vec_b, float beta,
                float* c, long long ldc, int tiles, int splits, int k_split,
                float* work, int* counters, void* stream) {
  Params p{a,     b,    c,     lda,   ldb,   ldc,     m,       n,
           k,     alpha, beta, vec_a, vec_b, k_split, work,    counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_a) {
    if (trans_b)
      launch_layout<true, true>(narrow, p, tiles, splits, s);
    else
      launch_layout<true, false>(narrow, p, tiles, splits, s);
  } else {
    if (trans_b)
      launch_layout<false, true>(narrow, p, tiles, splits, s);
    else
      launch_layout<false, false>(narrow, p, tiles, splits, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
