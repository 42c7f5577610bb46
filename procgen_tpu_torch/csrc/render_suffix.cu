// Static-prefix sprite suffix of the 64x64 frame render, for sm_90a.
//
// Replaces the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py
// (_render_env inside the pl.pallas_call at :1136) on its static-prefix
// path, which maze takes: start from the cached per-level frame (K1a),
// paint every entity slot in order into premultiplied RGBA canvases, one
// per z level, rounding each canvas to bf16 after every slot (K1b), then
// composite the canvases over the frame in z order and write uint8 (K1c).
// procgen_tpu_torch/render/render_kernel.py:render_suffix_reference is the
// same function in plain torch; the two agree byte for byte.  The slot
// code is shared with render_frame.cu (sprite.cuh).
//
// Bound: bytes.  Per env and step the kernel reads the 12 KiB base frame
// and writes the 12 KiB frame; the slot parameters (72 bytes a slot) and
// the atlas texels it touches (at most 4 bytes a pixel per slot, from a
// 80 KiB atlas that stays in L2) are small beside that.  At 4096 envs a
// launch moves ~100 MB.  Design: one thread per output pixel, grid
// (N, 16) of 256-thread blocks, one env's four pixel rows per block; the
// block stages its env's slot parameters in shared memory; each thread
// keeps its canvases in registers, so nothing but the frame itself goes
// through device memory.  The TPU kernel's 32-row slabs are a TPU
// scheduling device and are left out: outside a sprite's rect its alpha
// is 0, and blending with alpha 0 is an exact identity.
//
// Exactness: build with -fmad=false -prec-div=true -ftz=false (kernels.py)
// and keep the TPU kernel's operation order (pallas_kernel.py:719-830).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sprite.cuh"

namespace {

using namespace pgt;

constexpr int ROWS_PER_BLOCK = 4;
constexpr int THREADS = RES * ROWS_PER_BLOCK;

__global__ void __launch_bounds__(THREADS)
render_suffix_kernel(const uint8_t* __restrict__ base,
                     const float* __restrict__ ent_f,
                     const int32_t* __restrict__ ent_i,
                     const uint8_t* __restrict__ atlas,
                     uint8_t* __restrict__ out, int cap, int nz, int S,
                     int n_rows) {
  extern __shared__ int32_t smem[];
  float* sf = reinterpret_cast<float*>(smem);  // [cap, EF_N]
  int32_t* si = smem + cap * EF_N;             // [cap, EI_N]

  const int64_t env = blockIdx.x;
  load_slots(ent_f, ent_i, env, cap, sf, si);
  __syncthreads();

  const int row = blockIdx.y * ROWS_PER_BLOCK + threadIdx.x / RES;
  const int col = threadIdx.x % RES;

  float canv[MAX_NZ][4];
  paint_slots(sf, si, cap, nz, atlas, S, n_rows, (float)col + 0.5f,
              (float)row + 0.5f, canv);

  const int64_t px = ((env * RES + row) * RES + col) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float o = (float)base[px + c];
#pragma unroll
    for (int z = 0; z < MAX_NZ; ++z) {
      if (z < nz) o = rintf(canv[z][c] + o * (1.f - canv[z][3]));
    }
    out[px + c] = (uint8_t)(int32_t)o;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes by procgen_tpu_torch/kernels.py).
// base/out: uint8 [n, 64, 64, 3]; ent_f: f32 [n, cap, 8]; ent_i: int32
// [n, cap, 10]; atlas: uint8 [n_rows, S, S, 4].  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success).
extern "C" int render_suffix(const uint8_t* base, const float* ent_f,
                             const int32_t* ent_i, const uint8_t* atlas,
                             uint8_t* out, int n, int cap, int nz, int S,
                             int n_rows, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (nz < 1 || nz > MAX_NZ || cap < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n, RES / ROWS_PER_BLOCK);
  const size_t smem = (size_t)cap * (EF_N + EI_N) * sizeof(int32_t);
  render_suffix_kernel<<<grid, THREADS, smem, stream>>>(
      base, ent_f, ent_i, atlas, out, cap, nz, S, n_rows);
  return (int)cudaGetLastError();
}
