// Train-time augmentation for Hopper (sm_90a), bound with ctypes: for each
// uint8 image, the S x S crop at (dy, dx), columns mirrored if flip > 0,
// times `scale`, written as float32.
//
// Replaces the TPU kernel gltvae/ops/pallas/preprocess.py::_fused_augment
// (_augment_kernel), which both fused_augment_given and the stacked
// fused_augment_stacked_given reach. On the TPU the crop was two one-hot
// selection matmuls, R(dy) @ x @ E(dx, flip), because Mosaic refuses
// dynamic slices at unaligned sublane/lane offsets. Hopper has no such
// rule, so each output element loads its source byte by index.
//
// Bound: memory traffic. The function reads the S*S*C cropped bytes of
// each image once and writes S*S*C floats: 5 bytes per output element
// (plus 12 bytes of offsets per image), 15,728,640 B of pixels for a
// bs-256 64x64x3 step, about 4.7 us at the H100 SXM's 3.35 TB/s, the same
// as the dequant kernel. There is no reuse and no arithmetic worth
// counting.
//
// Design: one block per (image, group of kRowsPerBlock output rows); the
// block loads its own dy/dx/flip (what scalar prefetch did on the TPU).
// Threads walk the block's output rows in order; each makes four
// consecutive output elements (j, c) from source bytes
// [dy + i, dx + (flip ? S-1-j : j), c] and stores them as one float4, so
// neighbouring threads store to neighbouring 16-byte words. When a row of
// S*C floats is not a whole number of float4 (or the output base is not
// 16-byte aligned) the same loop stores one float at a time. The source
// window of a row is S*C bytes at an arbitrary byte offset; it is read
// byte by byte through the read-only cache, which a warp turns into a few
// 32-byte sectors. A faster version (TMA, wider loads) is later work.
//
// Offsets are clamped to [0, H-S] and [0, W-S], as XLA's dynamic_slice
// clamps in gltvae's augment_xla, so no offset reads outside its image.
// Every entry point draws offsets in range, so the clamp never changes a
// drawn crop.
//
// The scale is one IEEE f32 multiply (never build with --use_fast_math),
// so the kernel equals its plain torch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16;

__device__ __forceinline__ int clamp_to(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <int kWidth>
__global__ void __launch_bounds__(kThreads)
augment_kernel(const uint8_t* __restrict__ src, const int32_t* __restrict__ dy,
               const int32_t* __restrict__ dx, const int32_t* __restrict__ flip,
               float* __restrict__ out, int H, int W, int C, int S,
               float scale) {
  const int64_t b = blockIdx.x;
  const int y0 = clamp_to(dy[b], H - S);
  const int x0 = clamp_to(dx[b], W - S);
  const bool mirror = flip[b] > 0;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, S - row0);
  const int row_len = S * C;                 // output elements in a row
  const int per_row = row_len / kWidth;      // thread items in a row

  const uint8_t* img = src + b * H * W * C;
  float* o_img = out + b * S * S * C;
  for (int t = threadIdx.x; t < rows * per_row; t += kThreads) {
    const int r = t / per_row;
    const int e0 = (t - r * per_row) * kWidth;
    const int i = row0 + r;
    const uint8_t* s_row = img + (static_cast<int64_t>(y0 + i) * W + x0) * C;
    float v[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      const int e = e0 + k;
      const int j = e / C;
      const int c = e - j * C;
      const int js = mirror ? S - 1 - j : j;
      v[k] = static_cast<float>(__ldg(s_row + js * C + c)) * scale;
    }
    float* o = o_img + static_cast<int64_t>(i) * row_len + e0;
    if constexpr (kWidth == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      o[0] = v[0];
    }
  }
}

}  // namespace

// src: n_images x H x W x C uint8; dy, dx, flip: n_images int32 each;
// out: n_images x S x S x C float32. All contiguous on the current device.
extern "C" int gltvae_augment_u8_f32(const void* src, const void* dy,
                                     const void* dx, const void* flip,
                                     void* out, int64_t n_images, int H,
                                     int W, int C, int S, float scale,
                                     void* stream) {
  if (n_images <= 0 || S <= 0) return 0;
  if (H < S || W < S || C <= 0 || n_images > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_images),
                  static_cast<unsigned>((S + kRowsPerBlock - 1) / kRowsPerBlock));
  const bool vec = (S * C) % 4 == 0
                   && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const int32_t* y = static_cast<const int32_t*>(dy);
  const int32_t* x = static_cast<const int32_t*>(dx);
  const int32_t* f = static_cast<const int32_t*>(flip);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    augment_kernel<4><<<grid, kThreads, 0, st>>>(s, y, x, f, o, H, W, C, S,
                                                 scale);
  } else {
    augment_kernel<1><<<grid, kThreads, 0, st>>>(s, y, x, f, o, H, W, C, S,
                                                 scale);
  }
  return static_cast<int>(cudaGetLastError());
}
