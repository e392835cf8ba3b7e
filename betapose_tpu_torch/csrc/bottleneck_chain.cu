// Residual bottleneck chain for Hopper (sm_90a), on wgmma.
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
// Bound: 2*S*Cin*Cm + 18*S*Cm^2 + 2*S*Cm*Cin tensor-core FLOPs for S =
// B*H*W positions against 2*(2*S*Cin) + weight bytes.  At the probe shapes
// (batch 96; 13x13x1024->512, 10x8x2048->512, 20x16x1024->256) that is
// 111 / 68 / 68 GFLOP, 0.112 / 0.069 / 0.069 ms at the card's 989 TFLOP/s
// of dense bf16, against 0.022 / 0.021 / 0.038 ms for the bytes at 3.35
// TB/s: operations bound it.
//
// Design.  A block of two warpgroups takes a tile of TR x TC output
// positions of one frame (whole rows when a row fits) and keeps h1, over
// the tile's halo grid, and h2 in shared memory; y is written once.
//   Every product is turned around ("swap AB"): out^T[cout, pos] =
// W^T[cout, k] act^T[k, pos] on wgmma.mma_async m64nNk16.  A is a weight
// tile of 64 output channels per warpgroup, read transposed (MN-major)
// from the [k, cout] rows the weights are stored in, so nothing is
// repacked; channels past Cm or Cin are zero-filled.  B is the tile's
// positions, N their count rounded up to 16 (one instance per N, 16 to
// 256); the ragged end is masked in the epilogues.
//   Activations (x staging, h1, h2) are in the no-swizzle K-major layout:
// one slab per 8 channels, positions 16 bytes apart in it (SBO 128 bytes,
// LBO the slab's size).  The 3x3 runs over whole halo rows (hw = TC + 2
// positions a row; the two border columns are dropped in its epilogue), so
// tap (dy, dx) is the h1 descriptor with its start moved by (dy*hw + dx)*16
// bytes: nothing is gathered or copied.  The halo outside the frame is x
// zero-filled, whose h1 is 0: the 3x3's border.
//   Weights stream from L2 by cp.async into each warpgroup's own ring of
// kStages buffers, kKC = 16 deep and 4 steps ahead; a warpgroup syncs on
// its own named barrier and leaves one step of products in flight, so one
// warpgroup's products overlap the other's copies.  The h1 and h2
// epilogues round to bf16 into the slab layout; y's goes through a shared
// f32 tile, so that the residual x is read, and y written, 16 bytes a lane.
//   x is read from device memory (mostly L2) once per squeeze pass of 128
// channels by each warpgroup (Cm / 64 times; a tile's halo rows also by
// its neighbours), and once more for the residual.
//
// What holds it back: weight bytes per tile first.  Every block streams all
// of w1, w2 and w3 from L2 (6.8 / 8.9 / 2.2 MB at the probe shapes) for its
// 65 / 80 / 160 positions, and the time follows blocks x weight bytes: 1.41
// / 0.70 / 0.54 ms in 288 / 96 / 192 blocks (tiles 5x13, 10x8, 10x16) on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), against 0.45 / 0.36 /
// 0.62 ms for the cuDNN chain; with no weight copies the same tiles take
// 0.80 / 0.43 / 0.42 ms (tools/probe_chain_variants; PERF.md).  The 10x8
// frame whole (96 blocks, 36 SMs idle) is 1.8x faster than in two bands
// (192 blocks, twice the weight bytes): waves come second to bytes.  More
// buffers in flight do not help; blocks sharing weight tiles (clusters,
// TMA multicast) would cut the bytes.  The product pipeline itself comes
// next: a barrier every 16-deep step.
//
// Takes Cin and Cm in multiples of 8 (depth zero-padded to kKC and width
// to the 64 rows of a warpgroup inside the block), any H, W >= 1, and
// 16-byte aligned contiguous tensors.

#include <algorithm>
#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;     // two warpgroups
constexpr int kMB = 128;          // output channels a pass, 64 a warpgroup
constexpr int kKC = 16;           // depth of one pipeline step (one k16)
constexpr int kStages = 6;        // buffers a warpgroup: steps ahead + 2
constexpr int kMaxN = 256;        // positions a product: wgmma's widest N
constexpr int kNStep = 16;        // product widths are multiples of this
constexpr int kWHalf = kKC * 64 * 2;  // bytes of a warpgroup's weight buffer
constexpr int kYLd = kMB + 4;     // f32 row stride of the y staging tile

// Dense bf16 multiply-adds of the card per byte of weights its blocks
// stream from L2, for the planner: 494.5e12 MAC/s (989 TFLOP/s) over the
// about 1.4e12 B/s this kernel's weight streaming reached on an H100 SXM
// (PERF.md), so that a block's time is mostly its weight bytes.
constexpr double kMacPerL2Byte = 350.0;

struct Params {
  const bf16* x;
  const bf16* w1;
  const bf16* w2;
  const bf16* w3;
  bf16* y;
  int h, w, cin, cm;
  int tr, tc, tiles_c;  // tile rows, columns; tiles per frame along W
  int hw, p1, p2;       // halo row length tc + 2; halo and tile positions
  int n1, n3, n2;       // product widths (positions) of the three stages
  int cin_kc, cm_kc;    // depths rounded up to kKC
  int off_b, off_w;     // byte offsets of region B (h2, x staging), weights
};

// One stage of the chain as a product out[cout, pos] = W^T[cout, k] B[k, pos]
// over `taps` weight matrices [k, m] (row-major, `tap_stride` elements
// apart), for output channels [0, mout) in passes of kMB.
struct Stage {
  int kind;         // 0: squeeze (B: x staging), 1: 3x3 (h1), 2: expand (h2)
  const bf16* w;
  int k, m, kd, mout, taps;  // kd: depth k rounded up to kKC
  size_t tap_stride;
  uint32_t b;       // shared address of B (tap (0, 0); x staging buffer 0)
  uint32_t slab;    // bytes per 8-channel slab of B
};

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Make this thread's shared writes visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until at most kStages - 3 committed groups are still in flight (the
// copies of the step about to run have landed), then fence them for wgmma.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3) : "memory");
  fence_async_smem();
}

// Barrier of warpgroup g's 128 threads (named barrier 1 + g).
__device__ __forceinline__ void warpgroup_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, LBO
// (byte stride between core matrices along K), SBO (along M or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most R committed groups of products are still in flight.
template <int R>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(R) : "memory");
}

// Pin the accumulators at this point of the program, so that no access to
// them moves across a wgmma fence or wait.
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Wgmma<N>::run(d, a, b, acc): d[64 x N] = A[64 x 16] B[16 x N] (+ d when
// acc != 0) for one warpgroup, bf16 in, f32 accumulators; A from shared
// memory MN-major (transposed: the weights' [k, cout] rows), B K-major.  d
// holds, for n-block j and e in 0..3, row (warp % 4) * 16 + lane / 4 +
// 8 * (e / 2) and column 8 * j + 2 * (lane % 4) + e % 2 in d[4 * j + e].
template <int N>
struct Wgmma;
#define BC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BC_WGMMA(N, A, B, P)                                               \
  template <>                                                              \
  struct Wgmma<N> {                                                        \
    static __device__ __forceinline__ void run(float (&d)[N / 2],         \
                                               uint64_t a, uint64_t b,     \
                                               int accumulate) {           \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k16.f32.bf16.bf16 {" BC_S##N "}, " A ", " B            \
                   ", p, 1, 1, 1, 0;\n}\n"                                 \
                   : BC_D##N                                               \
                   : "l"(a), "l"(b), "r"(accumulate));                     \
    }                                                                      \
  };
// register lists and instances, N = 16 .. 256 in steps of 16
#define BC_S16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define BC_S32 BC_S16 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define BC_S48 BC_S32 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define BC_S64 BC_S48 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define BC_S80 BC_S64 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define BC_S96 BC_S80 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define BC_S112 BC_S96 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define BC_S128 BC_S112 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define BC_S144 BC_S128 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define BC_S160 BC_S144 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define BC_S176 BC_S160 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define BC_S192 BC_S176 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define BC_S208 BC_S192 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define BC_S224 BC_S208 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define BC_S240 BC_S224 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define BC_S256 BC_S240 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define BC_D16 BC_D4(0), BC_D4(4)
#define BC_D32 BC_D16, BC_D4(8), BC_D4(12)
#define BC_D48 BC_D32, BC_D4(16), BC_D4(20)
#define BC_D64 BC_D48, BC_D4(24), BC_D4(28)
#define BC_D80 BC_D64, BC_D4(32), BC_D4(36)
#define BC_D96 BC_D80, BC_D4(40), BC_D4(44)
#define BC_D112 BC_D96, BC_D4(48), BC_D4(52)
#define BC_D128 BC_D112, BC_D4(56), BC_D4(60)
#define BC_D144 BC_D128, BC_D4(64), BC_D4(68)
#define BC_D160 BC_D144, BC_D4(72), BC_D4(76)
#define BC_D176 BC_D160, BC_D4(80), BC_D4(84)
#define BC_D192 BC_D176, BC_D4(88), BC_D4(92)
#define BC_D208 BC_D192, BC_D4(96), BC_D4(100)
#define BC_D224 BC_D208, BC_D4(104), BC_D4(108)
#define BC_D240 BC_D224, BC_D4(112), BC_D4(116)
#define BC_D256 BC_D240, BC_D4(120), BC_D4(124)
BC_WGMMA(16, "%8", "%9", "%10")
BC_WGMMA(32, "%16", "%17", "%18")
BC_WGMMA(48, "%24", "%25", "%26")
BC_WGMMA(64, "%32", "%33", "%34")
BC_WGMMA(80, "%40", "%41", "%42")
BC_WGMMA(96, "%48", "%49", "%50")
BC_WGMMA(112, "%56", "%57", "%58")
BC_WGMMA(128, "%64", "%65", "%66")
BC_WGMMA(144, "%72", "%73", "%74")
BC_WGMMA(160, "%80", "%81", "%82")
BC_WGMMA(176, "%88", "%89", "%90")
BC_WGMMA(192, "%96", "%97", "%98")
BC_WGMMA(208, "%104", "%105", "%106")
BC_WGMMA(224, "%112", "%113", "%114")
BC_WGMMA(240, "%120", "%121", "%122")
BC_WGMMA(256, "%128", "%129", "%130")

// f(Width<N>()) for the instance N = n (a multiple of 16, 16 .. 256).
template <int N>
struct Width {
  static constexpr int value = N;
};
template <class F>
__device__ __forceinline__ void with_width(int n, F&& f) {
  switch (n / 16) {
#define BC_CASE(i)        \
  case i:                 \
    f(Width<16 * i>());   \
    break;
    BC_CASE(1) BC_CASE(2) BC_CASE(3) BC_CASE(4) BC_CASE(5) BC_CASE(6)
    BC_CASE(7) BC_CASE(8) BC_CASE(9) BC_CASE(10) BC_CASE(11) BC_CASE(12)
    BC_CASE(13) BC_CASE(14) BC_CASE(15) BC_CASE(16)
#undef BC_CASE
  }
}

// Copy rows [k0, k0 + kKC) x columns [m0, m0 + 64) of the row-major [K, M]
// matrix w into one warpgroup's weight buffer at dst, in the no-swizzle
// MN-major canonical layout: 128-byte core matrices of 8 k-rows x 8
// columns, core (column block mb, row block kb) at (mb * kKC / 8 + kb) *
// 128.  Rows >= K and columns >= M are zero-filled.  The 8-lane phases each
// fill one core matrix (no bank conflicts); a warp reads 8 rows of 64
// contiguous bytes.
__device__ __forceinline__ void stage_weights(uint32_t dst, const bf16* w,
                                              int K, int M, int k0, int m0) {
  const int wt = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < kKC * 64 / 8 / 128; ++j) {
    const int q = wt + j * 128;
    const int kr = q % 8, mb = (q / 8) % 8, kb = q / 64;
    const int k = k0 + kb * 8 + kr, m = m0 + mb * 8;
    const bool ok = k < K && m < M;
    cp_async16(dst + (mb * (kKC / 8) + kb) * 128 + kr * 16,
               ok ? w + static_cast<size_t>(k) * M + m : w, ok);
  }
}

struct Tile {
  int r0, c0;           // the tile's first frame row and column
  const bf16* xb;       // this frame of x
  bf16* yb;             // this frame of y
  unsigned char* smem;
};

// One stage at product width N (positions, >= the stage's own count).
// Each warpgroup runs its own pipeline over its 64 output channels of every
// pass of kMB: its own weight buffers (and, in the squeeze, its own x
// staging), a named barrier of its 128 threads per step, products left in
// flight one step (wgmma wait_group 1), so that one warpgroup's products
// overlap the other's copies and barriers.  The steps of all passes form
// one sequence, so the next pass's copies are in flight during an epilogue.
template <int N>
__device__ __forceinline__ void run_stage(const Params& p, const Stage& s,
                                          const Tile& t) {
  const int g = threadIdx.x >> 7;          // warpgroup: channels g * 64 ..
  const int wt = threadIdx.x & 127;
  const int wq = wt >> 5;                  // warp within the warpgroup
  const int lane = threadIdx.x & 31;
  const uint32_t wbuf =
      smem_addr(t.smem) + p.off_w + g * kStages * kWHalf;
  const int ks = s.kd / kKC;
  const int steps = s.taps * ks;
  const int total = (s.mout + kMB - 1) / kMB * steps;

  // squeeze: this thread's x staging copies, as element offsets into the
  // frame (-1: zero-fill, outside the frame or past the halo; -2: none).
  // The 8-lane phases fill 8 consecutive positions of one slab; x is read
  // in runs of kKC channels per position.
  constexpr int kXC = (N * kKC / 8 + 127) / 128;
  constexpr uint32_t kXBuf = N * kKC * 2;   // bytes of one x staging buffer
  const uint32_t xbuf = s.b + g * kStages * kXBuf;
  int xoff[kXC];
  if (s.kind == 0) {
#pragma unroll
    for (int j = 0; j < kXC; ++j) {
      const int q = wt + j * 128;
      const int pos = (q / kKC) * 8 + q % 8;
      const int hr = pos / p.hw, hc = pos - hr * p.hw;
      const int fr = t.r0 - 1 + hr, fc = t.c0 - 1 + hc;
      const bool in = pos < p.p1 && fr >= 0 && fr < p.h && fc >= 0 &&
                      fc < p.w;
      xoff[j] = q >= N * kKC / 8 ? -2
                : in ? (fr * p.w + fc) * p.cin + (q / 8) % (kKC / 8) * 8
                     : -1;
    }
  }
  const uint32_t slab = s.kind == 0 ? N * 16 : s.slab;

  // a step: pass (kMB output channels), tap, depth window within the tap
  struct Cursor {
    int pass, tap, kb;
  };
  auto advance = [&](Cursor& c) {
    if (++c.kb == ks) {
      c.kb = 0;
      if (++c.tap == s.taps) {
        c.tap = 0;
        ++c.pass;
      }
    }
  };
  // issue the copies of step c into buffer buf
  auto stage = [&](const Cursor& c, int buf) {
    const int k0 = c.kb * kKC;
    stage_weights(wbuf + buf * kWHalf, s.w + c.tap * s.tap_stride, s.k, s.m,
                  k0, c.pass * kMB + g * 64);
    if (s.kind == 0) {
#pragma unroll
      for (int j = 0; j < kXC; ++j) {
        if (xoff[j] == -2) continue;
        const int q = wt + j * 128;
        const int c8 = (q / 8) % (kKC / 8);
        const int pos = (q / kKC) * 8 + q % 8;
        const bool ok = xoff[j] >= 0 && k0 + c8 * 8 < p.cin;
        cp_async16(xbuf + buf * kXBuf + c8 * N * 16 + pos * 16,
                   ok ? t.xb + xoff[j] + k0 : p.x, ok);
      }
    }
  };

  // kStages - 2 steps of copies in flight ahead of the one in use.  The
  // barrier of step u also tells that every warp of the warpgroup is done
  // with the products of step u - 2, whose buffer the next copy overwrites.
  // The steps of all passes form one sequence, so that the next pass's
  // copies are in flight during an epilogue.
  Cursor ahead = {0, 0, 0};
  int issued = 0, ahead_buf = 0;
  auto stage_next = [&]() {
    if (issued < total) {
      stage(ahead, ahead_buf);
      advance(ahead);
      ++issued;
      ahead_buf = ahead_buf + 1 == kStages ? 0 : ahead_buf + 1;
    }
    cp_async_commit();
  };
  for (int u = 0; u < kStages - 2; ++u) stage_next();

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  hold(acc);
  int buf = 0;
  for (int pass = 0; pass < total / steps; ++pass) {
    for (int tap = 0; tap < s.taps; ++tap) {
      // the 3x3's tap (dy, dx) is B shifted by dy * hw + dx positions
      const uint32_t shift = s.kind == 1 ? ((tap / 3) * p.hw + tap % 3) * 16
                                         : 0;
      for (int kb = 0; kb < ks; ++kb) {
        cp_async_wait_stage();
        warpgroup_sync(g);
        stage_next();

        const int k0 = kb * kKC;
        const uint32_t bs = s.kind == 0 ? xbuf + buf * kXBuf
                                        : s.b + (k0 / 8) * slab + shift;
        const uint32_t as = wbuf + buf * kWHalf;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) {
          // the pass's first product overwrites the accumulators
          Wgmma<N>::run(acc, smem_desc(as + kk * 256, 128, kKC * 16),
                        smem_desc(bs + kk * 2 * slab, slab, 128),
                        (tap | kb | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        buf = buf + 1 == kStages ? 0 : buf + 1;
      }
    }
    wgmma_wait<0>();
    hold(acc);

    // epilogue of the pass: this thread's rows (output channels) and
    // columns (positions), as Wgmma<N> lays them out
    const int m0 = pass * kMB + g * 64;
    const int mrow = m0 + wq * 16 + lane / 4;
    if (s.kind == 0 || s.kind == 1) {
      // h = bf16(relu(acc)) into the slab layout; channels past Cm (up to
      // Cm rounded up to kKC) get zeros, the padding the next stage's depth reads
      unsigned char* base = t.smem + (s.kind == 0 ? 0 : p.off_b);
      const int pstride = s.kind == 0 ? p.p1 * 16 : p.p2 * 16;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = mrow + 8 * (e >> 1);
          const int n = 8 * j + 2 * (lane & 3) + (e & 1);
          int pos = n;
          bool ok = c < s.mout;
          if (s.kind == 0) {
            ok = ok && n < p.p1;
          } else {
            // the 3x3 ran over whole halo rows: drop the two border columns
            const int r = n / p.hw, cc = n - r * p.hw;
            ok = ok && r < p.tr && cc < p.tc;
            pos = r * p.tc + cc;
          }
          if (ok)
            *reinterpret_cast<bf16*>(base + (c >> 3) * pstride + pos * 16 +
                                     (c & 7) * 2) =
                __float2bfloat16_rn(fmaxf(acc[4 * j + e], 0.f));
        }
      }
    } else {
      // y = bf16(relu(acc + x)): the warpgroup's f32 tile goes through
      // shared memory (its 64 columns of a tile aliasing h1, dead by now)
      // so that x is read and y written in 16 bytes a lane, 128 contiguous
      // bytes a position
      float* ys = reinterpret_cast<float*>(t.smem) + g * 64;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 8 * j + 2 * (lane & 3) + (e & 1);
          ys[n * kYLd + wq * 16 + lane / 4 + 8 * (e >> 1)] = acc[4 * j + e];
        }
      warpgroup_sync(g);
      for (int i = wt; i < p.p2 * 8; i += 128) {
        const int n = i / 8, c8 = i % 8;
        const int c = m0 + c8 * 8;
        const int r = n / p.tc, cc = n - r * p.tc;
        const int fr = t.r0 + r, fc = t.c0 + cc;
        if (c >= p.cin || fr >= p.h || fc >= p.w) continue;
        const size_t off = (static_cast<size_t>(fr) * p.w + fc) * p.cin + c;
        const uint4 xv = *reinterpret_cast<const uint4*>(t.xb + off);
        const float4 a0 =
            *reinterpret_cast<const float4*>(ys + n * kYLd + c8 * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(ys + n * kYLd + c8 * 8 + 4);
        const float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const __nv_bfloat162* x2 =
            reinterpret_cast<const __nv_bfloat162*>(&xv);
        uint4 out;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 xf = __bfloat1622float2(x2[k]);
          o2[k] = __floats2bfloat162_rn(fmaxf(v[2 * k] + xf.x, 0.f),
                                        fmaxf(v[2 * k + 1] + xf.y, 0.f));
        }
        *reinterpret_cast<uint4*>(t.yb + off) = out;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bottleneck_chain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  const size_t frame = static_cast<size_t>(p.h) * p.w * p.cin;
  Tile t;
  t.r0 = (blockIdx.x / p.tiles_c) * p.tr;
  t.c0 = (blockIdx.x % p.tiles_c) * p.tc;
  t.xb = p.x + blockIdx.y * frame;
  t.yb = p.y + blockIdx.y * frame;
  t.smem = smem;

  // 1. h1 = relu(x @ w1) over the halo grid, x streamed through staging
  // 2. h2 = relu(conv3x3(h1, w2)) over whole halo rows of the tile
  // 3. y = relu(h2 @ w3 + x)
  // Between stages every thread's shared writes are made visible to the
  // other warpgroup's products.
  // The stage is selected from uniform values (no array indexed at run
  // time), so that the compiler sees the products' control flow as uniform:
  // wgmma in what it takes for a divergent path is serialized.
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    Stage s;
    s.kind = i;
    s.w = i == 0 ? p.w1 : i == 1 ? p.w2 : p.w3;
    s.k = i == 0 ? p.cin : p.cm;
    s.m = i == 2 ? p.cin : p.cm;
    s.kd = i == 0 ? p.cin_kc : p.cm_kc;
    s.mout = i == 2 ? p.cin : p.cm_kc;
    s.taps = i == 1 ? 9 : 1;
    s.tap_stride = static_cast<size_t>(p.cm) * p.cm;
    s.b = i == 1 ? s0 : s0 + p.off_b;
    s.slab = (i == 1 ? p.p1 : p.p2) * 16;
    with_width(i == 0 ? p.n1 : i == 1 ? p.n3 : p.n2, [&](auto n) {
      run_stage<decltype(n)::value>(p, s, t);
    });
    fence_async_smem();
    __syncthreads();
  }
}

// Shared memory of a TR x TC tile: region A (h1 over the halo grid, later
// the f32 y staging tile), region B (the x staging buffers, later h2), the
// weight buffers.  False when the squeeze's width passes kMaxN.
struct Plan {
  int tr, tc, tiles_r, tiles_c, hw, p1, p2, n1, n3, n2, off_b, off_w, bytes;
};

bool make_plan(int h, int w, int tr, int tc, int cm, Plan* q) {
  const int cm_kc = round_up(cm, kKC);
  q->tr = tr;
  q->tc = tc;
  q->tiles_r = (h + tr - 1) / tr;
  q->tiles_c = (w + tc - 1) / tc;
  q->hw = tc + 2;
  q->p1 = (tr + 2) * q->hw;
  q->p2 = tr * tc;
  q->n1 = round_up(q->p1, kNStep);
  q->n3 = round_up(tr * q->hw, kNStep);
  q->n2 = round_up(q->p2, kNStep);
  if (q->n1 > kMaxN) return false;
  // the 3x3's last columns read up to n3 - tr * hw + 2 positions past h1's
  // last slab, and the expand's up to n2 - p2 past h2's: both land in the
  // regions after them, and feed only columns that are dropped
  // (at most kMaxN positions, so every size here is well within an int)
  const int a = round_up(std::max(q->p1 * cm_kc * 2, q->n2 * kYLd * 4), 128);
  const int b = round_up(
      std::max(q->p2 * cm_kc * 2, 2 * kStages * q->n1 * kKC * 2), 128);
  q->off_b = a;
  q->off_w = a + b;
  q->bytes = a + b + 2 * kStages * kWHalf;
  return true;
}

struct Device {
  int smem;  // dynamic shared memory a block may have
  int sms;   // streaming multiprocessors
};

// The current device's limits.  The first call on a device also raises the
// kernel's dynamic shared memory limit to the most a block can have, so
// that later launches (and CUDA-graph captures of them) make no attribute
// calls.
bool device_limits(Device* d) {
  constexpr int kMaxDevices = 64;
  static Device cache[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return false;
  if (cache[dev].smem == 0) {
    int optin = 0, sms = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(bottleneck_chain_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    cache[dev] = {optin, sms};
  }
  *d = cache[dev];
  return true;
}

// The tile for B frames of H x W: whole rows when one row fits (else the
// fewest column bands that do), then the number of row bands that the
// least time estimate picks.  One block runs on an SM at a time (the
// kernel's registers), so blocks go in waves of `sms`; a block's time is
// its padded multiply-adds at the SM's share of the card's rate, and all
// blocks together read every weight once each from L2, shared by the card:
//   est = max(waves * macs * sms, blocks * l2_bytes * kMacPerL2Byte).
// Ties go to fewer bands.  False when not even one position fits.
bool plan_tiles(int b, int h, int w, int cin, int cm, const Device& d,
                Plan* best) {
  Plan q;
  int tc = w;
  for (int cb = 1; cb <= w; ++cb) {
    tc = (w + cb - 1) / cb;
    if (make_plan(h, w, 1, tc, cm, &q) && q.bytes <= d.smem) break;
  }
  if (!make_plan(h, w, 1, tc, cm, &q) || q.bytes > d.smem) return false;
  const double cin_kc = round_up(cin, kKC), cm_kc = round_up(cm, kKC);
  const double m1 = round_up(cm_kc, kMB), m3 = round_up(cin, kMB);
  const double wbytes = 2.0 * (2.0 * cin * cm + 9.0 * cm * cm);
  double best_est = -1;
  for (int rb = 1; rb <= h; ++rb) {
    const int tr = (h + rb - 1) / rb;
    if (rb > 1 && (h + rb - 2) / (rb - 1) == tr) continue;   // same tile
    if (!make_plan(h, w, tr, tc, cm, &q) || q.bytes > d.smem) continue;
    const double blocks = static_cast<double>(b) * q.tiles_r * q.tiles_c;
    const double waves = std::ceil(blocks / d.sms);
    const double macs = q.n1 * cin_kc * m1 + 9.0 * q.n3 * cm_kc * m1 +
                        q.n2 * cm_kc * m3;
    // weights; x once a squeeze pass by each warpgroup, once for the
    // residual
    const double l2 = wbytes + 2.0 * cin * (2.0 * q.p1 * m1 / kMB + q.p2);
    const double est = std::max(waves * macs * d.sms,
                                blocks * l2 * kMacPerL2Byte);
    if (best_est < 0 || est < best_est) {
      best_est = est;
      *best = q;
    }
  }
  return best_est >= 0;
}

bool plan_for(int b, int h, int w, int cin, int cm, Plan* q) {
  Device d;
  return device_limits(&d) && plan_tiles(b, h, w, cin, cm, d, q);
}

}  // namespace

// The plan the kernel takes for these sizes on the current device:
// out = {tile rows, tile columns, blocks, shared bytes per block, product
// widths of the squeeze, the 3x3 and the expand}.  Returns 0, or
// cudaErrorInvalidValue when no tile fits.
extern "C" int bottleneck_chain_plan(int b, int h, int w, int cin, int cm,
                                     int* out) {
  Plan q;
  if (cin % 8 != 0 || cm % 8 != 0 || h < 1 || w < 1 || cin < 8 || cm < 8 ||
      !plan_for(b, h, w, cin, cm, &q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v[7] = {q.tr, q.tc, b * q.tiles_r * q.tiles_c, q.bytes,
                    q.n1, q.n3, q.n2};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// x, y: [B, H, W, Cin] bf16; w1: [Cin, Cm]; w2: [9, Cm, Cm]; w3: [Cm, Cin];
// all contiguous and 16-byte aligned, Cin and Cm multiples of 8.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// when the sizes are out of range or no tile fits Cm in shared memory.
extern "C" int bottleneck_chain_launch(const void* x, const void* w1,
                                       const void* w2, const void* w3,
                                       void* y, int b, int h, int w, int cin,
                                       int cm, void* stream) {
  if (cin % 8 != 0 || cm % 8 != 0 || b < 0 || b > 65535 || h < 1 || w < 1 ||
      cin < 8 || cm < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan q;
  if (!plan_for(b > 0 ? b : 1, h, w, cin, cm, &q))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.tr = q.tr;
  p.tc = q.tc;
  p.tiles_c = q.tiles_c;
  p.hw = q.hw;
  p.p1 = q.p1;
  p.p2 = q.p2;
  p.n1 = q.n1;
  p.n3 = q.n3;
  p.n2 = q.n2;
  p.cin_kc = round_up(cin, kKC);
  p.cm_kc = round_up(cm, kKC);
  p.off_b = q.off_b;
  p.off_w = q.off_w;
  const dim3 grid(q.tiles_r * q.tiles_c, b);
  bottleneck_chain_kernel<<<grid, kThreads, q.bytes,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
