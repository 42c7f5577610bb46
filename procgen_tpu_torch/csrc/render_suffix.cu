// Static-prefix sprite suffix of the 64x64 frame render, for sm_90a.
//
// Replaces the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py
// (_render_env inside the pl.pallas_call at :1136) on its static-prefix
// path, which maze and plunder take: start from the cached per-level frame
// (K1a), paint every slot in order into premultiplied RGBA canvases, one
// per z level of each sprite pool, rounding each canvas to bf16 after every
// slot (K1b), then composite the canvases over the frame and write uint8
// (K1c).  procgen_tpu/render/render_kernel.py:render_suffix_reference is
// the same function in plain torch; the two agree byte for byte.  The slot
// code is shared with render_frame.cu (sprite.cuh).
//
// Two instances, picked once a launch by the C entry point:
// render_suffix_kernel<false> (maze) paints the entity pool's cap slots and
// composites its canvases in index order; render_suffix_kernel<true>
// (plunder) also stages the decor pool's slots, walks each pool to its live
// count, and composites at z = 0, then z = 1, the entity pool's canvas and
// then the decor pool's (pallas_kernel.py:936-967).  The decor pool's
// tests stay out of the entity-only instance.
//
// Bound: bytes.  Per env and step the kernel reads the 12 KiB base frame
// and writes the 12 KiB frame; the slot parameters (72 bytes a slot) and
// the atlas texels it touches (at most 4 bytes a pixel per slot, from an
// atlas that stays in L2) are small beside that.  At 4096 envs a launch
// moves ~100 MB.  Design: one 256-thread block per env.  The block copies
// the env's base frame into shared memory 16 bytes a thread, stages both
// pools' slots and plans their painting once (sprite.cuh: the list of the
// slots that paint, their texel index per pixel column and per pixel row,
// and per row a mask of the slots that cover it); then each thread takes
// one pixel column of every fourth row, so a warp is 32 columns of one row
// and walks that row's mask, keeps the pixel's canvases in registers,
// composites them over the staged pixel and writes it back in place; the
// block stores the frame 16 bytes a thread.  The TPU kernel's 32-row slabs
// are a TPU scheduling device and are left out: outside a sprite's rect its
// alpha is 0, and blending with alpha 0 is an exact identity.
//
// Exactness: build with -fmad=false -prec-div=true -ftz=false (kernels.py)
// and keep the TPU kernel's operation order (pallas_kernel.py:719-830).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sprite.cuh"

namespace {

using namespace pgt;

constexpr int THREADS = 256;

// The pools' shapes: slots, canvases, the canvases' composite order.
struct Pools {
  int cap, dcap, nz, nzd;
  CanvasOrder order;
  int S, n_rows;
};

// Dynamic shared memory of one block: the frame, then the slot tables.
size_t suffix_smem(int cap, int dcap) {
  return align16(FRAME_BYTES) + slot_tables_bytes(cap + dcap);
}

template <bool DECOR>
__global__ void __launch_bounds__(THREADS)
render_suffix_kernel(const uint8_t* __restrict__ base,
                     const float* __restrict__ ent_f,
                     const int32_t* __restrict__ ent_i,
                     const float* __restrict__ dec_f,
                     const int32_t* __restrict__ dec_i,
                     const int32_t* __restrict__ counts,
                     const uint8_t* __restrict__ atlas,
                     uint8_t* __restrict__ out, Pools p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Carve cv{smem};
  uint8_t* frame = cv.take<uint8_t>(FRAME_BYTES);
  SlotTables t;
  t.carve(cv, p.cap + p.dcap);

  const int64_t env = blockIdx.x;
  copy_frame(frame, base + env * FRAME_BYTES);
  load_slots(ent_f, ent_i, env, p.cap, 0, t);
  if constexpr (DECOR) load_slots(dec_f, dec_i, env, p.dcap, p.cap, t);
  clear_masks(t, p.cap + p.dcap);
  __syncthreads();
  if (threadIdx.x < 32) {
    if constexpr (DECOR)
      compact_slots(t, p.cap, p.dcap, clampi(counts[env * 2], 0, p.cap),
                    clampi(counts[env * 2 + 1], 0, p.dcap), p.nz, p.nzd,
                    p.order, p.S, p.n_rows);
    else
      compact_slots(t, p.cap, 0, p.cap, 0, p.nz, 0, p.order, p.S, p.n_rows);
  }
  __syncthreads();
  axis_tables(t, p.S);
  __syncthreads();

  const uchar4* texels = reinterpret_cast<const uchar4*>(atlas);
  const int col = threadIdx.x % RES;
  for (int row = threadIdx.x / RES; row < RES; row += THREADS / RES) {
    float canv[MAX_CANVASES][4];
    clear_canvases(canv);
    // a pixel no slot painted keeps its byte: round(byte) is the byte
    if (!paint_pixel(t, row, col, texels, p.S, canv)) continue;
    uint8_t* px = frame + (row * RES + col) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      px[c] = (uint8_t)(int32_t)composite_range((float)px[c], canv, 0,
                                                p.order.end_all, c, true);
  }
  __syncthreads();
  copy_frame(out + env * FRAME_BYTES, frame);
}

}  // namespace

// Plain C entry point (loaded with ctypes by procgen_tpu_torch/kernels.py).
// base/out: uint8 [n, 64, 64, 3]; ent_f / dec_f: f32 [n, cap|dcap, 8];
// ent_i / dec_i: int32 [n, cap|dcap, 10]; counts: int32 [n, 2], the live
// counts of the entity and decor pools; atlas: uint8 [n_rows, S, S, 4],
// S <= 255 (the axis tables are uint8).  dcap == 0 launches the
// entity-only instance, which reads no decor pointer and no count;
// otherwise z0/z1 and dz0/dz1 are each pool's canvas index of z = 0 and
// z = 1 among its nz / nzd canvases, or -1 for none.  Refuses pools whose
// block would need more than 227 KiB of shared memory.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int render_suffix(const uint8_t* base, const float* ent_f,
                             const int32_t* ent_i, const float* dec_f,
                             const int32_t* dec_i, const int32_t* counts,
                             const uint8_t* atlas, uint8_t* out, int n,
                             int cap, int dcap, int nz, int nzd, int z0,
                             int z1, int dz0, int dz1, int S, int n_rows,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool decor = dcap > 0;
  bool ok = nz >= 1 && cap >= 0 && dcap >= 0 && S >= 1 && S < OUTSIDE &&
            n_rows >= 1 && nz + (decor ? nzd : 0) <= MAX_CANVASES;
  if (decor)
    ok = ok && nzd >= 1 && z0 >= -1 && z0 < nz && z1 >= -1 && z1 < nz &&
         dz0 >= -1 && dz0 < nzd && dz1 >= -1 && dz1 < nzd;
  // the entity-only instance composites its canvases in index order; the
  // decor instance at z = 0, then z = 1, the entity pool's canvas and then
  // the decor pool's (pallas_kernel.py:951-967)
  CanvasOrder order{};
  if (ok && decor) {
    const int zs[2] = {z0, z1}, dzs[2] = {dz0, dz1};
    ok = make_order(zs, dzs, 2, 0, nz, &order);
  } else if (ok) {
    const int zs[MAX_CANVASES] = {0, 1, 2, 3}, none[MAX_CANVASES] = {-1, -1, -1, -1};
    ok = make_order(zs, none, nz, 0, nz, &order);
  }
  const size_t smem = suffix_smem(cap, dcap);
  if (!ok || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Pools p{cap, dcap, nz, decor ? nzd : 0, order, S, n_rows};
  auto kernel = decor ? render_suffix_kernel<true> : render_suffix_kernel<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)n, THREADS, smem, stream>>>(base, ent_f, ent_i, dec_f,
                                                 dec_i, counts, atlas, out, p);
  return (int)cudaGetLastError();
}

// The compiled instance's resources at these pools (pgt::occupancy).
extern "C" int render_suffix_occupancy(int cap, int dcap, int* out) {
  auto kernel = dcap > 0 ? render_suffix_kernel<true> : render_suffix_kernel<false>;
  return occupancy(kernel, suffix_smem(cap, dcap), THREADS, out);
}
