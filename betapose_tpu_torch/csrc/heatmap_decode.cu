// Heatmap peak decode for Hopper (sm_90a).
//
// Replaces the TPU kernel betapose_tpu/ops/pallas/heatmap_decode.py
// (`decode_peaks` -> `_decode_kernel`).  Per [H, W] map of a [B, K, H, W]
// float32 stack it writes (x, y, maxval, 0) with the reference semantics
// (KPD/src/utils/eval.py:113-141):
//   - row-major FIRST-occurrence argmax and its value maxval;
//   - x = idx % W, y = idx / W, both set to 0 unless maxval > 0;
//   - on strict-interior peaks, +-0.25 * sign(right - left) on x and
//     +-0.25 * sign(down - up) on y;
//   - +0.2 on both coordinates.
// Every step is exact or rounds once, in the order of the plain PyTorch
// version (ops/kernels/heatmap_decode.py, decode_peaks_plain), so the two
// agree bit for bit.
//
// Bound: the kernel reads each input float once and writes 16 bytes per
// map, B*K*H*W*4 + B*K*16 bytes.  At the main path's [8, 50, 80, 64] that is
// 8.19 MB, about 2.4 us at the H100's 3.35 TB/s; the work is a compare per
// element, far below the card's compute, so it is memory-bound.  The design
// reads each map exactly once, with 16-byte loads (float4) where the map
// allows them: one block of 256 threads per map (400 blocks at B=8), a
// strided per-thread (value, index) pair, then a warp-shuffle and a
// shared-memory reduction whose comparison keeps the lower index on equal
// values.  Exact ties are common: the maps are bf16 activations cast to f32.
// The four neighbour reads of the refinement come from global memory (L2).
//
// NaN is not ordered here as torch.argmax orders it; the network's maps are
// finite.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_peaks_kernel(const float* __restrict__ hms, float* __restrict__ out,
                    int h, int w) {
  const int hw = h * w;
  const float* m = hms + static_cast<size_t>(blockIdx.x) * hw;
  float bv = -INFINITY;
  int bi = INT_MAX;

  if (kVec) {
    const float4* m4 = reinterpret_cast<const float4*>(m);
    for (int j = threadIdx.x; j < hw / 4; j += kThreads) {
      const float4 q = m4[j];
      take(q.x, 4 * j, bv, bi);
      take(q.y, 4 * j + 1, bv, bi);
      take(q.z, 4 * j + 2, bv, bi);
      take(q.w, 4 * j + 3, bv, bi);
    }
  } else {
    for (int j = threadIdx.x; j < hw; j += kThreads) take(m[j], j, bv, bi);
  }

  // warp reduction, then one value per warp through shared memory
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(ov, oi, bv, bi);
  }
  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;
  bv = lane < kWarps ? s_v[lane] : -INFINITY;
  bi = lane < kWarps ? s_i[lane] : INT_MAX;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(ov, oi, bv, bi);
  }
  if (lane != 0) return;

  const float maxval = bv;
  int x = bi % w;
  int y = bi / w;
  if (!(maxval > 0.f)) {
    x = 0;
    y = 0;
  }
  float ax = 0.f;
  float ay = 0.f;
  if (x > 0 && x < w - 1 && y > 0 && y < h - 1) {
    const int c = y * w + x;
    const float right = m[c + 1], left = m[c - 1];
    const float down = m[c + w], up = m[c - w];
    ax = right > left ? 0.25f : (right < left ? -0.25f : 0.f);
    ay = down > up ? 0.25f : (down < up ? -0.25f : 0.f);
  }
  float* o = out + static_cast<size_t>(blockIdx.x) * 4;
  o[0] = (static_cast<float>(x) + ax) + 0.2f;
  o[1] = (static_cast<float>(y) + ay) + 0.2f;
  o[2] = maxval;
  o[3] = 0.f;
}

}  // namespace

// hms: [maps, h, w] float32, contiguous; out: [maps, 4] float32.
// vec != 0 requires (h * w) % 4 == 0 and a 16-byte aligned hms.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_peaks_launch(const void* hms, void* out, int maps,
                                   int h, int w, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(hms);
  float* o = static_cast<float*>(out);
  if (vec) {
    decode_peaks_kernel<true><<<maps, kThreads, 0, s>>>(in, o, h, w);
  } else {
    decode_peaks_kernel<false><<<maps, kThreads, 0, s>>>(in, o, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
