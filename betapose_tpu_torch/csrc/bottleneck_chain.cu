// Residual bottleneck chain for Hopper (sm_90a).
//
// Replaces the TPU kernel betapose_tpu/ops/pallas/bottleneck_chain.py
// (`bottleneck_chain_pallas` -> `_chain_kernel`).  For x [B, H, W, Cin]
// (NHWC, bf16) and BN-folded weights w1 [Cin, Cm], w2 [9, Cm, Cm] (3x3 taps,
// row-major dy, dx) and w3 [Cm, Cin] it writes
//
//     h1 = bf16(relu(x @ w1))                      1x1 squeeze
//     h2 = bf16(relu(conv3x3(h1, w2)))             zero outside the frame
//     y  = bf16(relu(f32(h2 @ w3) + f32(x)))       1x1 expand + residual
//
// with f32 accumulation, rounding at exactly the points of the plain
// version (ops/kernels/bottleneck_chain.py, bottleneck_chain_plain).
//
// Bound: 2*S*Cin*Cm + 18*S*Cm^2 + 2*S*Cm*Cin tensor-core FLOPs for
// S = B*H*W positions against 2*(2*S*Cin) + weight bytes.  At the probe
// shapes (batch 96; 13x13x1024->512, 10x8x2048->512, 20x16x1024->256) that
// is 68-111 GFLOP against 31-75 MB, so the card's 989 TFLOP/s of dense bf16
// bounds it (0.07-0.11 ms), not its 3.35 TB/s of HBM (0.02-0.04 ms).
//
// Design.  The Pallas kernel keeps a whole batch tile's x in VMEM; one
// frame's x alone (346 KB at 13x13x1024) is larger than the 227 KB of
// shared memory a Hopper block can have.  So a block takes one tile of
// TR x TC output positions of one frame (the host picks the largest tile
// whose buffers fit, in whole rows when a row fits):
//   1. h1 for the tile and its one-position halo goes to shared memory as
//      bf16; halo positions outside the frame stay zero (the 3x3's zero
//      border).  x streams through a staging buffer that aliases h2.
//   2. The 3x3 is 9 products of shifted h1 rows (a gather of row
//      addresses; nothing is copied) with w2's taps; h2 goes to shared
//      memory as bf16.
//   3. The expand, the residual add and the relu, and y is stored once.
// x is read from device memory twice per tile: once for h1 (its halo rows
// also by the neighbouring tile) and again, in step 3's epilogue, for the
// residual (4-byte loads per lane, likely L2 hits).  y is written once; h1
// and h2 never leave the SM.
// Weights stay in global memory and are read through L2 (2-9 MB, resident)
// into a double-buffered shared tile by cp.async.  Products run on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulators), with
// fragments loaded by ldmatrix; every block product is cut into chunks of
// 128 rows x 128 columns, over 8 warps (2 x 4, 64 x 32 each), with one
// barrier per 32-deep step.
// This first version runs far below the tensor cores' rate on the H100
// (PERF.md): one block per SM of 8 warps issuing mma.sync on tiles of
// 50-160 positions cannot keep them busy, and deeper copy pipelines did not
// help.  The redesign (wgmma on larger tiles of positions, clusters sharing
// weight tiles) is later work.
//
// Takes Cin and Cm in multiples of 8 (depth and width are zero-padded to
// 16 inside the block), any H, W >= 1, and 16-byte aligned contiguous
// tensors.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMC = 128;        // rows of one chunk of a block product
constexpr int kNC = 128;        // columns of one chunk
constexpr int kKC = 32;         // depth of one pipeline step
constexpr int kK16 = kKC / 16;  // k16 slices per step
constexpr int kStages = 2;      // pipeline buffers (steps in flight + 1);
                                // 3 and 4 measured no faster on the H100
constexpr int kPad = 8;         // bf16 padding per shared row (banks)
constexpr int kALd = kKC + kPad;
constexpr int kBLd = kNC + kPad;
constexpr int kAStage = kMC * kALd;   // elements per x staging buffer
constexpr int kBStage = kKC * kBLd;   // elements per weight buffer
constexpr int kACopies = kMC * kKC / 8 / kThreads;  // 16-byte copies per
constexpr int kBCopies = kKC * kNC / 8 / kThreads;  // thread and step

struct Params {
  const bf16* x;
  const bf16* w1;
  const bf16* w2;
  const bf16* w3;
  bf16* y;
  int h, w, cin, cm;
  int tr, tc;            // output tile rows, columns
  int tiles_r, tiles_c;  // tiles per frame along H, W
  int cin16, cm16;       // depths rounded up to 16
  int ld;                // shared row stride of h1 and h2 (cm16 + kPad)
  int off_h2, off_b;     // byte offsets of the h2 and weight regions
};

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Byte sizes of the three shared regions for a TR x TC tile:
// h1 (with halo), h2 (aliased by x staging) and the weight buffers.
__host__ inline void region_bytes(int tr, int tc, int cm, size_t* h1,
                                  size_t* h2, size_t* b) {
  const size_t row = (static_cast<size_t>(cm + 15) / 16 * 16 + kPad) * 2;
  const size_t h1b = static_cast<size_t>(tr + 2) * (tc + 2) * row;
  const size_t h2b = static_cast<size_t>(tr) * tc * row;
  const size_t stage = kStages * kAStage * 2;
  *h1 = (h1b + 127) / 128 * 128;
  *h2 = ((h2b > stage ? h2b : stage) + 127) / 128 * 128;
  *b = kStages * kBStage * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kStages - 2 committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [k0, k0 + kKC) x columns [n0, n0 + kNC) of the row-major
// [K, N] weight matrix w into the shared buffer dst; rows >= K and columns
// >= N are zero-filled: kBCopies copies of 16 bytes per thread.
__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* w,
                                              int K, int N, int k0, int n0) {
#pragma unroll
  for (int j = 0; j < kBCopies; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int r = q / (kNC / 8);
    const int c = (q % (kNC / 8)) * 8;
    const bool ok = (k0 + r < K) && (n0 + c < N);
    const bf16* src = ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w;
    cp_async16(dst + r * kBLd + c, src, ok);
  }
}

// One chunk of a block product: acc (this warp's 64 x 32 share of a
// 128 x 128 chunk) = sum over `steps` pipeline steps of A_s @ B_s.
//   stage(s, buf): issue the cp.async copies of step s into buffer buf;
//   arow[mi]: this lane's A row pointer for m16 tile mi of the warp, and
//   a_off(s, buf): the offset (elements) of step s's depth window from it;
//   depth16(s): k16 slices of step s that hold data (1 to kK16).
// The per-step index arithmetic is kept out of the m16 x k16 loops.
// Ends with every thread past its last read of the buffers.  Copies run
// kStages - 1 steps ahead of the products.
template <class Stage, class AOff, class Depth>
__device__ __forceinline__ void chunk_product(
    float (&acc)[4][4][4], int steps, int m_rows, const bf16* bstage,
    const bf16* const (&arow)[4], Stage stage, AOff a_off, Depth depth16) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // ldmatrix lane addressing: A k offset; B k row within a k16 slice and
  // n offset within an n16 pair
  const int a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_n = warp_n * 32 + (lane >> 4) * 8;

  // kStages - 1 steps in flight; one barrier per step: it also tells
  // that every warp is done with the buffer the next copy overwrites
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s % kStages;
    cp_async_wait_stage();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < steps) stage(next, next % kStages);
    cp_async_commit();
    const bf16* bs = bstage + buf * kBStage;
    const int nk = depth16(s);
    const int aoff = a_off(s, buf) + a_k;
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk) {
      if (kk >= nk) break;
      uint32_t bfr[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk * 16 + b_k) * kBLd + b_n + j * 16);
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if ((warp_m + 2 * mi) * 16 >= m_rows) break;
        uint32_t a[4];
        ldmatrix_x4(a, arow[mi] + aoff + kk * 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a, bfr[ni][0],
                                                bfr[ni][1]);
      }
    }
  }
  __syncthreads();
}

// Hand each accumulated pair to emit(row, col, v0, v1): rows < m_rows of
// the chunk, even columns col, col + 1 of the chunk.
template <class Emit>
__device__ __forceinline__ void chunk_epilogue(const float (&acc)[4][4][4],
                                               int m_rows, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int mt = warp_m + 2 * mi;
    if (mt * 16 >= m_rows) break;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = warp_n * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + g + half * 8;
        if (row < m_rows)
          emit(row, col, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

// This lane's ldmatrix A row within m16 tile mi of the warp.
__device__ __forceinline__ int lane_a_row(int mi) {
  const int lane = threadIdx.x & 31;
  const int warp_m = (threadIdx.x >> 5) >> 2;
  return (warp_m + 2 * mi) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
}

__global__ void __launch_bounds__(kThreads, 1)
bottleneck_chain_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h1 = reinterpret_cast<bf16*>(smem);
  bf16* h2 = reinterpret_cast<bf16*>(smem + p.off_h2);
  bf16* astage = h2;                       // x staging aliases h2
  bf16* bstage = reinterpret_cast<bf16*>(smem + p.off_b);

  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / p.tiles_c) * p.tr;
  const int c0 = (blockIdx.x % p.tiles_c) * p.tc;
  const int tr = min(p.tr, p.h - r0);
  const int tc = min(p.tc, p.w - c0);
  const int hw = p.tc + 2;                 // halo grid row length
  const int ld = p.ld;
  const bf16* xb = p.x + static_cast<size_t>(b) * p.h * p.w * p.cin;

  // h1 starts as zeros: the halo outside the frame is the 3x3's border
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < p.off_h2 / 16; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  float acc[4][4][4];

  // ---- 1. h1 = relu(x @ w1) over the in-frame halo positions ----
  const int fr_lo = max(r0 - 1, 0), fr_hi = min(r0 + tr, p.h - 1);
  const int fc_lo = max(c0 - 1, 0), fc_hi = min(c0 + tc, p.w - 1);
  const int ncol1 = fc_hi - fc_lo + 1;
  const int m1 = (fr_hi - fr_lo + 1) * ncol1;
  const int steps1 = (p.cin16 + kKC - 1) / kKC;
  for (int m0 = 0; m0 < m1; m0 += kMC) {
    const int mr = min(kMC, m1 - m0);
    // this thread's staging rows (fixed across steps)
    const bf16* xrow[kACopies];
    bool xok[kACopies];
    int xr[kACopies], xc[kACopies];
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
      const int q = threadIdx.x + j * kThreads;
      xr[j] = q / (kKC / 8);
      xc[j] = (q % (kKC / 8)) * 8;
      const int i = m0 + xr[j];
      xok[j] = i < m1;
      const int fr = fr_lo + (xok[j] ? i / ncol1 : 0);
      const int fc = fc_lo + (xok[j] ? i % ncol1 : 0);
      xrow[j] = xb + (static_cast<size_t>(fr) * p.w + fc) * p.cin;
    }
    const bf16* arow[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) arow[mi] = astage + lane_a_row(mi) * kALd;
    for (int n0 = 0; n0 < p.cm16; n0 += kNC) {
      auto stage = [&](int s, int buf) {
        const int k0 = s * kKC;
#pragma unroll
        for (int j = 0; j < kACopies; ++j) {
          const bool ok = xok[j] && (k0 + xc[j] < p.cin);
          cp_async16(astage + buf * kAStage + xr[j] * kALd + xc[j],
                     ok ? xrow[j] + k0 + xc[j] : p.x, ok);
        }
        stage_weights(bstage + buf * kBStage, p.w1, p.cin, p.cm, k0, n0);
      };
      auto a_off = [](int, int buf) { return buf * kAStage; };
      auto depth16 = [&](int s) {
        return min(kK16, (p.cin16 - s * kKC) / 16);
      };
      chunk_product(acc, steps1, mr, bstage, arow, stage, a_off, depth16);
      chunk_epilogue(acc, mr, [&](int row, int col, float v0, float v1) {
        const int n = n0 + col;
        if (n >= p.cm16) return;
        const int i = m0 + row;
        const int fr = fr_lo + i / ncol1, fc = fc_lo + i % ncol1;
        const int hidx = (fr - r0 + 1) * hw + (fc - c0 + 1);
        *reinterpret_cast<__nv_bfloat162*>(h1 + hidx * ld + n) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      });
    }
  }
  __syncthreads();

  // ---- 2. h2 = relu(conv3x3(h1, w2)) over the tile's positions ----
  const int m2 = tr * tc;
  const int ksteps = (p.cm16 + kKC - 1) / kKC;
  for (int m0 = 0; m0 < m2; m0 += kMC) {
    const int mr = min(kMC, m2 - m0);
    const bf16* arow[4];   // this lane's h1 row at tap (0, 0)
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int i = m0 + lane_a_row(mi);
      arow[mi] = h1 + (i < m2 ? (i / tc) * hw + (i % tc) : 0) * ld;
    }
    for (int n0 = 0; n0 < p.cm16; n0 += kNC) {
      auto stage = [&](int s, int buf) {
        const int tap = s / ksteps;
        stage_weights(bstage + buf * kBStage,
                      p.w2 + static_cast<size_t>(tap) * p.cm * p.cm, p.cm,
                      p.cm, (s % ksteps) * kKC, n0);
      };
      auto a_off = [&](int s, int) {
        const int tap = s / ksteps;
        return ((tap / 3) * hw + tap % 3) * ld + (s - tap * ksteps) * kKC;
      };
      auto depth16 = [&](int s) {
        return min(kK16, (p.cm16 - (s % ksteps) * kKC) / 16);
      };
      chunk_product(acc, 9 * ksteps, mr, bstage, arow, stage, a_off,
                    depth16);
      chunk_epilogue(acc, mr, [&](int row, int col, float v0, float v1) {
        const int n = n0 + col;
        if (n >= p.cm16) return;
        *reinterpret_cast<__nv_bfloat162*>(h2 + (m0 + row) * ld + n) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      });
    }
  }
  __syncthreads();

  // ---- 3. y = relu(h2 @ w3 + x) ----
  for (int m0 = 0; m0 < m2; m0 += kMC) {
    const int mr = min(kMC, m2 - m0);
    const bf16* arow[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int i = m0 + lane_a_row(mi);
      arow[mi] = h2 + (i < m2 ? i : 0) * ld;
    }
    for (int n0 = 0; n0 < p.cin; n0 += kNC) {
      auto stage = [&](int s, int buf) {
        stage_weights(bstage + buf * kBStage, p.w3, p.cm, p.cin, s * kKC,
                      n0);
      };
      auto a_off = [](int s, int) { return s * kKC; };
      auto depth16 = [&](int s) { return min(kK16, (p.cm16 - s * kKC) / 16); };
      chunk_product(acc, ksteps, mr, bstage, arow, stage, a_off, depth16);
      chunk_epilogue(acc, mr, [&](int row, int col, float v0, float v1) {
        const int n = n0 + col;
        if (n >= p.cin) return;
        const int i = m0 + row;
        const size_t off =
            (static_cast<size_t>(r0 + i / tc) * p.w + c0 + i % tc) * p.cin +
            n;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xb + off));
        bf16* yb = p.y + static_cast<size_t>(b) * p.h * p.w * p.cin;
        *reinterpret_cast<__nv_bfloat162*>(yb + off) = __floats2bfloat162_rn(
            fmaxf(v0 + xv.x, 0.f), fmaxf(v1 + xv.y, 0.f));
      });
    }
  }
}

size_t tile_bytes(int tr, int tc, int cm) {
  size_t h1, h2, b;
  region_bytes(tr, tc, cm, &h1, &h2, &b);
  return h1 + h2 + b;
}

// The tile for an [H, W] frame: whole rows when one row fits in `budget`
// bytes (else the widest column band that does), then as many rows as
// fit, then the same number of bands with their rows (columns) spread
// evenly.  Returns false when not even one position fits.
bool plan_tiles(int h, int w, int cm, size_t budget, int* tr, int* tc) {
  int c = w;
  while (c > 1 && tile_bytes(1, c, cm) > budget) c = (c + 1) / 2;
  if (tile_bytes(1, c, cm) > budget) return false;
  int r = 1;
  while (r < h && tile_bytes(r + 1, c, cm) <= budget) ++r;
  const int bands = (h + r - 1) / r;
  const int cols = (w + c - 1) / c;
  *tr = (h + bands - 1) / bands;
  *tc = (w + cols - 1) / cols;
  return true;
}

// The current device's shared memory per block.  The first call on a
// device also raises the kernel's dynamic shared memory limit to it, so
// that later launches (and CUDA-graph captures of them) make no attribute
// calls.
size_t smem_budget() {
  constexpr int kMaxDevices = 64;
  static int budget[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return 0;
  if (budget[dev] == 0) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(bottleneck_chain_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    budget[dev] = optin;
  }
  return static_cast<size_t>(budget[dev]);
}

}  // namespace

// x, y: [B, H, W, Cin] bf16; w1: [Cin, Cm]; w2: [9, Cm, Cm]; w3: [Cm, Cin];
// all contiguous and 16-byte aligned, Cin and Cm multiples of 8.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// when the sizes are out of range or no tile fits Cm in shared memory.
extern "C" int bottleneck_chain_launch(const void* x, const void* w1,
                                       const void* w2, const void* w3,
                                       void* y, int b, int h, int w, int cin,
                                       int cm, void* stream) {
  if (cin % 8 != 0 || cm % 8 != 0 || b < 0 || h < 1 || w < 1 || cin < 8 ||
      cm < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int plan[3];
  if (!plan_tiles(h, w, cm, smem_budget(), &plan[0], &plan[1]))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[2] = static_cast<int>(tile_bytes(plan[0], plan[1], cm));
  if (b == 0) return 0;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
  p.w3 = static_cast<const bf16*>(w3);
  p.y = static_cast<bf16*>(y);
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cm = cm;
  p.tr = plan[0];
  p.tc = plan[1];
  p.tiles_r = (h + p.tr - 1) / p.tr;
  p.tiles_c = (w + p.tc - 1) / p.tc;
  p.cin16 = round_up(cin, 16);
  p.cm16 = round_up(cm, 16);
  p.ld = p.cm16 + kPad;
  size_t h1b, h2b, bb;
  region_bytes(p.tr, p.tc, cm, &h1b, &h2b, &bb);
  p.off_h2 = static_cast<int>(h1b);
  p.off_b = static_cast<int>(h1b + h2b);
  const int bytes = plan[2];
  const dim3 grid(p.tiles_r * p.tiles_c, b);
  bottleneck_chain_kernel<<<grid, kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
