// uint8 -> float32 image dequant for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel gltvae/ops/pallas/preprocess.py::_normalize_2d
// (and, in its divide form, the XLA dequant of gltvae/train/steps.py::
// _as_f32_image that every train and eval step runs).
//
// Bound: pure memory traffic. Each input byte is read once and each output
// float written once: 5 bytes per element, 15,728,640 B for a bs-256
// 64x64x3 batch, about 4.7 us at the H100 SXM's 3.35 TB/s. There is no
// reuse and no arithmetic worth counting, so the design is a plain
// vectorised stream: each thread loads 16 bytes as one uint4 and writes
// four float4 (16-byte accesses, neighbouring threads on neighbouring
// addresses), in a grid-stride loop. Elements before the first 16-byte
// aligned source address, and the numel % 16 tail, are handled by scalar
// code in the same kernel. When the source and destination cannot both be
// 16-byte aligned at the same element, the vector loop keeps its uint4
// loads and stores floats one by one.
//
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
constexpr int64_t kMaxBlocks = 132 * 16;

template <bool kDiv>
__device__ __forceinline__ float convert(uint32_t v, float scale) {
  const float f = static_cast<float>(v);
  return kDiv ? f / 255.0f : f * scale;
}

template <bool kDiv>
__device__ __forceinline__ void convert_word(uint32_t w, float scale,
                                             float out[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = convert<kDiv>((w >> (8 * j)) & 0xFFu, scale);
}

// src + head is 16-byte aligned; n_vec 16-byte vectors follow it, then
// `tail` elements. dst_vec says whether dst + head is 16-byte aligned too.
template <bool kDiv>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint8_t* __restrict__ src, float* __restrict__ dst,
               int64_t head, int64_t n_vec, int64_t tail, float scale,
               bool dst_vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  float* vdst = dst + head;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const uint4 q = vsrc[i];
    float f[16];
    convert_word<kDiv>(q.x, scale, f);
    convert_word<kDiv>(q.y, scale, f + 4);
    convert_word<kDiv>(q.z, scale, f + 8);
    convert_word<kDiv>(q.w, scale, f + 12);
    float* o = vdst + 16 * i;
    if (dst_vec) {
      float4* o4 = reinterpret_cast<float4*>(o);
      o4[0] = make_float4(f[0], f[1], f[2], f[3]);
      o4[1] = make_float4(f[4], f[5], f[6], f[7]);
      o4[2] = make_float4(f[8], f[9], f[10], f[11]);
      o4[3] = make_float4(f[12], f[13], f[14], f[15]);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) o[j] = f[j];
    }
  }

  // Scalar edges: the unaligned head, then the tail after the vectors.
  const int64_t tail_start = head + 16 * n_vec;
  for (int64_t i = tid; i < head + tail; i += stride) {
    const int64_t e = i < head ? i : tail_start + (i - head);
    dst[e] = convert<kDiv>(src[e], scale);
  }
}

}  // namespace

extern "C" int gltvae_dequant_u8_f32(const void* src, void* dst, int64_t n,
                                     int mode, float scale, void* stream) {
  if (n <= 0) return 0;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  float* d = static_cast<float*>(dst);
  int64_t head = static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15);
  if (head > n) head = n;
  const int64_t n_vec = (n - head) / 16;
  const int64_t tail = n - head - 16 * n_vec;
  const bool dst_vec = ((reinterpret_cast<uintptr_t>(d + head)) & 15) == 0;

  const int64_t work = n_vec > head + tail ? n_vec : head + tail;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    dequant_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        s, d, head, n_vec, tail, scale, dst_vec);
  } else {
    dequant_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        s, d, head, n_vec, tail, scale, dst_vec);
  }
  return static_cast<int>(cudaGetLastError());
}
