// uint8 -> float32 image dequant for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel gltvae/ops/pallas/preprocess.py::_normalize_2d
// (and, in its divide form, the XLA dequant of gltvae/train/steps.py::
// _as_f32_image that every train and eval step runs).
//
// Bound: pure memory traffic. Each input byte is read once and each output
// float written once: 5 bytes per element, 15,728,640 B for a bs-256
// 64x64x3 batch, about 4.7 us at the H100 SXM's 3.35 TB/s. There is no
// reuse and no arithmetic worth counting, so the kernel must keep the read
// and the write streams both busy and both coalesced.
//
// Design: one block of 256 threads per 4 KB tile of the source (768
// tiles, one wave, at (256, 64, 64, 3)). Thread t loads source words t,
// t + 256, t + 512, t + 768 of its tile, all four before its first store
// (a warp's load is 128 contiguous bytes), and stores each word's four
// floats as one float4: a warp's store covers 512 contiguous bytes, every
// 32-byte sector written whole by one instruction. The tiles start at
// the first 16-byte aligned source byte, so every word load is aligned;
// the bytes before it (the head) and after the last whole tile (the tail)
// go through a scalar path in the same launch. When dst + head is not
// 16-byte aligned, the stores are scalar. The wrapper
// (ops/preprocess.py::dequant_plan) computes head, tiles, tail and grid on
// the host.
//
// Shared memory earns nothing here. Timed in turns in one process on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): this design
// 6.33-6.70 us at (256, 64, 64, 3), 70-74% of the bound; the same blocks
// fed by one 1-D TMA bulk copy into shared memory 6.73-6.89 us; a
// persistent grid with a 4-stage TMA ring 6.92-7.06 us; the earlier
// design 13.1-13.4 us. At four times the bytes the three new designs were
// within 1% of one another.

// Two forms, both correctly rounded, so the kernel equals its plain torch
// version bit for bit:
//   mode 0 (divide):   v / 255.0f   (IEEE division: never build with
//                                    --use_fast_math or -prec-div=false)
//   mode 1 (multiply): v * scale    (what the Pallas kernel computes)
// The two differ in the last ulp for 126 of the 256 byte values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;       // source bytes per tile (ops/preprocess.py)

template <bool kDiv>
__device__ __forceinline__ float convert(uint32_t v, float scale) {
  const float f = static_cast<float>(v);
  return kDiv ? f / 255.0f : f * scale;
}

template <bool kDiv>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint8_t* __restrict__ src, float* __restrict__ dst,
               int64_t head, int64_t tiles, int64_t tail, float scale,
               bool dst_vec) {
  constexpr int kWords = kTile / 4 / kThreads;
  const int64_t g = blockIdx.x;
  uint32_t q[kWords];
  if (g < tiles) {
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(src + head + g * kTile);
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      q[j] = __ldg(words + threadIdx.x + j * kThreads);
  }

  // Scalar edges while the words load: the unaligned head, then the tail
  // after the whole tiles.
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tail_start = head + tiles * kTile;
  for (int64_t i = g * kThreads + threadIdx.x; i < head + tail; i += stride) {
    const int64_t e = i < head ? i : tail_start + (i - head);
    dst[e] = convert<kDiv>(src[e], scale);
  }
  if (g >= tiles) return;

  float* o = dst + head + g * kTile;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int w = threadIdx.x + j * kThreads;
    const float4 f = make_float4(convert<kDiv>(q[j] & 0xFFu, scale),
                                 convert<kDiv>((q[j] >> 8) & 0xFFu, scale),
                                 convert<kDiv>((q[j] >> 16) & 0xFFu, scale),
                                 convert<kDiv>(q[j] >> 24, scale));
    if (dst_vec) {
      reinterpret_cast<float4*>(o)[w] = f;
    } else {
      o[4 * w] = f.x;
      o[4 * w + 1] = f.y;
      o[4 * w + 2] = f.z;
      o[4 * w + 3] = f.w;
    }
  }
}

}  // namespace

// src: n = head + tiles * tile + tail uint8; dst: n float32. src + head is
// 16-byte aligned, tile is kTile and grid at least tiles: block g < tiles
// converts tile g (ops/preprocess.py::dequant_plan).
extern "C" int gltvae_dequant_u8_f32(const void* src, void* dst, int64_t head,
                                     int64_t tiles, int64_t tail, int tile,
                                     int grid, int dst_vec, int mode,
                                     float scale, void* stream) {
  if (head < 0 || head > 15 || tiles < 0 || tail < 0 || tail >= kTile
      || grid < 1 || grid < tiles || tile != kTile
      || (tiles > 0 && ((reinterpret_cast<uintptr_t>(src) + head) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (head + tiles + tail == 0) return 0;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  float* d = static_cast<float*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(grid);
  if (mode == 0) {
    dequant_kernel<true><<<blocks, kThreads, 0, st>>>(s, d, head, tiles, tail,
                                                      scale, dst_vec != 0);
  } else {
    dequant_kernel<false><<<blocks, kThreads, 0, st>>>(s, d, head, tiles,
                                                       tail, scale,
                                                       dst_vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
