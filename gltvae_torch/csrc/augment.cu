// Train-time augmentation for Hopper (sm_90a), bound with ctypes: for each
// uint8 image, the S x S crop at (dy, dx), columns mirrored if flip > 0,
// times `scale`, written as float32.
//
// Replaces the TPU kernel gltvae/ops/pallas/preprocess.py::_fused_augment
// (_augment_kernel), which both fused_augment_given and the stacked
// fused_augment_stacked_given reach. On the TPU the crop was two one-hot
// selection matmuls, R(dy) @ x @ E(dx, flip), because Mosaic refuses
// dynamic slices at unaligned sublane/lane offsets. Hopper has no such
// rule, so each output element takes its source byte by index.
//
// Bound: memory traffic. The function reads the S*S*C cropped bytes of
// each image once and writes S*S*C floats: 5 bytes per output element
// (plus 12 bytes of offsets per image), 15,728,640 B of pixels for a
// bs-256 64x64x3 step, about 4.7 us at the H100 SXM's 3.35 TB/s, the same
// as the dequant kernel. There is no reuse and no arithmetic worth
// counting.
//
// Design: one block per (image, group of R output rows); the block loads
// its own dy/dx/flip (what scalar prefetch did on the TPU). The source
// rows y0+row0 ... y0+row0+R-1 are R*W*C contiguous bytes (pad columns
// included: 2.5% more bytes than the bound counts at 72 -> 64 px). Thread
// 0 copies them into shared memory with one 1-D TMA bulk copy of their
// 16-byte rounded window, clamped inside the tensor; the few bytes that
// window leaves out at an unaligned tensor start or end are loaded one by
// one (tests/test_torch_kernel_plan.py mirrors the rule on the host and
// sweeps it). Then each thread makes four consecutive output elements
// (j, c) from shared memory, source column x0 + (flip ? S-1-j : j), and
// stores them as one float4, so a warp stores 512 contiguous bytes; the
// block's output rows are one contiguous range. C is a template parameter
// (3 and 1, plus a generic runtime-C instance), so no element pays an
// integer division by a runtime value. When a row of S*C floats is not a
// whole number of float4 (or the output base is not 16-byte aligned) the
// same loop stores one float at a time. The wrapper
// (ops/preprocess.py::augment_plan) picks R (32 rows at 72 -> 64 px: 6.9 KB
// of shared memory, two blocks an image) and the shared-memory size.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 8,
// and in turns with other designs; PERF.md, section 6): per step (256, 72,
// 72, 3) -> 64 7.2-7.4 us, 63-65% of the bound; stacked (4, 256, ...)
// 26.1-26.4 us, 71-72%. The same window loaded by 16-byte loads of all
// threads, in place of the one bulk copy, was 7% slower per step (the
// default path) and 2% faster stacked.
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

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448 - 64;   // 227 KB less the static barrier

__device__ __forceinline__ int clamp_to(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// kC: channels (0: runtime c_rt); kWidth: output elements per store.
template <int kC, int kWidth>
__global__ void __launch_bounds__(kThreads)
augment_kernel(const uint8_t* __restrict__ src, int64_t src_bytes,
               const int32_t* __restrict__ dy, const int32_t* __restrict__ dx,
               const int32_t* __restrict__ flip, float* __restrict__ out,
               int H, int W, int c_rt, int S, int rows_per_group,
               float scale) {
  extern __shared__ __align__(128) uint8_t span[];
  __shared__ __align__(8) uint64_t bar;
  const int C = kC > 0 ? kC : c_rt;
  const int64_t b = blockIdx.x;
  const int y0 = clamp_to(dy[b], H - S);
  const int x0 = clamp_to(dx[b], W - S);
  const bool mirror = flip[b] > 0;
  const int row0 = blockIdx.y * rows_per_group;
  const int rows = min(rows_per_group, S - row0);
  const int64_t WC = static_cast<int64_t>(W) * C;

  // The block's source rows [lo, hi); span[i] holds the byte at a0 + i.
  // [a, z) is their 16-byte rounded window, clamped inside the tensor.
  const uintptr_t base = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = base + (b * H + y0 + row0) * WC;
  const uintptr_t hi = lo + rows * WC;
  const uintptr_t a0 = lo & ~uintptr_t{15};
  const uintptr_t first = (base + 15) & ~uintptr_t{15};
  const uintptr_t last = (base + src_bytes) & ~uintptr_t{15};
  const uintptr_t hi16 = (hi + 15) & ~uintptr_t{15};
  const uintptr_t a = a0 > first ? a0 : first;
  const uintptr_t z = hi16 < last ? hi16 : last;
  const bool wide = a < z;
  if (threadIdx.x == 0 && wide) {
    gltvae::mbar_init(&bar);
    gltvae::bulk_load(span + (a - a0), reinterpret_cast<const void*>(a),
                      static_cast<uint32_t>(z - a), &bar);
  }
  // Scalar edges: the span's bytes before a and from z on (all of it
  // when there is no window).
  const uintptr_t head_end = !wide ? hi : (a > lo ? a : lo);
  const uintptr_t tail_start = !wide ? hi : (z < hi ? z : hi);
  for (uintptr_t p = lo + threadIdx.x; p < head_end; p += kThreads)
    span[p - a0] = *reinterpret_cast<const uint8_t*>(p);
  for (uintptr_t p = tail_start + threadIdx.x; p < hi; p += kThreads)
    span[p - a0] = *reinterpret_cast<const uint8_t*>(p);
  __syncthreads();
  if (wide) gltvae::mbar_wait(&bar, 0);

  // Output item t of the block (kWidth elements) is element q * kWidth of
  // output row r: t = r * per_row + q, stepped without dividing.
  const uint8_t* crop = span + (lo - a0) + x0 * C;
  float* o = out + ((b * S + row0) * S) * C;
  const int per_row = S * C / kWidth;
  const int dr = kThreads / per_row, dq = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, q = threadIdx.x - r * per_row;
  for (int t = threadIdx.x; t < rows * per_row; t += kThreads) {
    const uint8_t* s_row = crop + r * WC;
    const int e0 = q * kWidth;
    int j = e0 / C, c = e0 - j * C;
    float v[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      v[k] = static_cast<float>(s_row[(mirror ? S - 1 - j : j) * C + c])
             * scale;
      if (++c == C) {
        c = 0;
        ++j;
      }
    }
    if constexpr (kWidth == 4) {
      reinterpret_cast<float4*>(o)[t] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      o[t] = v[0];
    }
    q += dq;
    r += dr;
    if (q >= per_row) {
      q -= per_row;
      ++r;
    }
  }
}

template <int kC, int kWidth>
cudaError_t launch(dim3 grid, int smem, cudaStream_t st, const uint8_t* src,
                   int64_t src_bytes, const int32_t* dy, const int32_t* dx,
                   const int32_t* flip, float* out, int H, int W, int C,
                   int S, int rows_per_group, float scale) {
  auto* kernel = augment_kernel<kC, kWidth>;
  if (smem > 48 * 1024) {   // opt in, on the current device, each launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, st>>>(src, src_bytes, dy, dx, flip, out, H,
                                       W, C, S, rows_per_group, scale);
  return cudaGetLastError();
}

template <int kWidth>
cudaError_t launch_c(dim3 grid, int smem, cudaStream_t st, const uint8_t* src,
                     int64_t src_bytes, const int32_t* dy, const int32_t* dx,
                     const int32_t* flip, float* out, int H, int W, int C,
                     int S, int rows_per_group, float scale) {
  if (C == 3)
    return launch<3, kWidth>(grid, smem, st, src, src_bytes, dy, dx, flip,
                             out, H, W, C, S, rows_per_group, scale);
  if (C == 1)
    return launch<1, kWidth>(grid, smem, st, src, src_bytes, dy, dx, flip,
                             out, H, W, C, S, rows_per_group, scale);
  return launch<0, kWidth>(grid, smem, st, src, src_bytes, dy, dx, flip, out,
                           H, W, C, S, rows_per_group, scale);
}

}  // namespace

// src: n_images x H x W x C uint8, src_bytes long; dy, dx, flip: n_images
// int32 each; out: n_images x S x S x C float32. All contiguous on the
// current device. rows_per_group, smem_bytes and vec come from
// ops/preprocess.py::augment_plan.
extern "C" int gltvae_augment_u8_f32(const void* src, int64_t src_bytes,
                                     const void* dy, const void* dx,
                                     const void* flip, void* out,
                                     int64_t n_images, int H, int W, int C,
                                     int S, int rows_per_group,
                                     int smem_bytes, int vec, float scale,
                                     void* stream) {
  if (n_images <= 0 || S <= 0) return 0;
  const int64_t row_bytes = static_cast<int64_t>(W) * C;
  const int64_t groups = (S + rows_per_group - 1) / rows_per_group;
  if (H < S || W < S || C <= 0 || n_images > 0x7FFFFFFF
      || rows_per_group < 1 || rows_per_group > S || groups > 65535
      || smem_bytes < rows_per_group * row_bytes + 30
      || smem_bytes > kMaxSmem || src_bytes < n_images * H * row_bytes
      || (vec && ((S * C) % 4 != 0
                  || (reinterpret_cast<uintptr_t>(out) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_images),
                  static_cast<unsigned>(groups));
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const int32_t* y = static_cast<const int32_t*>(dy);
  const int32_t* x = static_cast<const int32_t*>(dx);
  const int32_t* f = static_cast<const int32_t*>(flip);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_c<4>(grid, smem_bytes, st, s, src_bytes, y, x, f, o, H, W,
                        C, S, rows_per_group, scale)
          : launch_c<1>(grid, smem_bytes, st, s, src_bytes, y, x, f, o, H, W,
                        C, S, rows_per_group, scale);
  return static_cast<int>(err);
}
