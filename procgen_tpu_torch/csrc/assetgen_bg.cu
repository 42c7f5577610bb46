// The per-reset painted background of use_generated_assets, for sm_90a.
//
// Computes what procgen_tpu/render/assetgen.py generate_background computes
// (AssetGen::generate_resource(img, 1, 50, true) over a 500x500 rect,
// assetgen.cpp:104-132, painted at 128x128) for every env, from the env's
// next N_MAX words of its level rand_gen.  The JAX package runs it under
// jit at every reset (basic-abstract-game.cpp:776-782), no Pallas kernel:
// 1.2 million primitive operations a call, a masked walk of 99 blotches
// that each hold up to 19 inner ones.  It is no TPU kernel's port; the
// port needs it because its host would dispatch those operations one by
// one.  procgen_tpu_torch/core/assetgen.py generate_background_reference
// is the same function in plain torch; the two agree byte for byte.
//
// Two kernels a chunk of envs:
//   walk   one thread an env follows the C++ control flow with its cursor
//          (assetgen_host._paint_rect_resource has the same), in f32 as
//          the JAX package computes, and writes the env's paints in paint
//          order to a list in global memory: rect fills, ellipses with a
//          1-px pen, and the 200/255 alpha fills that close a resource,
//          at most 1 + 99 * 40 + 1 = 3,962 of them; it writes the words
//          used.
//   paint  four 512-thread blocks an env, 32 canvas rows each, one thread a
//          column and eight rows, each pixel's RGB in f32 registers; the
//          block stages the list in shared memory 256 paints at a time and
//          applies them in order (a paint's column span first), then
//          rounds half to even, clips and stores uint8.
//
// Bound: bytes.  The words used read once (int64 each) and the canvas
// written (48 KiB an env).  The walk is serial per env: its latency, not
// bytes, is what it costs at a replenish chunk of 64 envs.
//
// Exactness: build with -fmad=false -prec-div=true (kernels.py), keep the
// JAX package's operation order; alpha and 1 - alpha are f32 values rounded
// from the doubles 200/255 and 1 - 200/255; x ** 2 is x * x; the constants
// are the f32 roundings of the JAX package's Python floats, as hex.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAN = 128;
constexpr float CELL = 3.90625f;  // 500 / 128
constexpr int PAINT_FILL = 1, PAINT_ELLIPSE = 2, PAINT_BLEND = 3;
constexpr float ALPHA = 0x1.919192p-1f;          // f32(200/255)
constexpr float ONE_MINUS_ALPHA = 0x1.b9b9bap-3f;  // f32(1 - 200/255)
constexpr float EPS = 0x1.a36e2ep-14f;           // f32(1e-4)
constexpr float C03 = 0x1.333334p-2f, C07 = 0x1.666666p-1f;
constexpr float C005 = 0x1.99999ap-5f, C05 = 0.5f, C075 = 0.75f;

constexpr int WALK_THREADS = 128;
constexpr int PAINT_THREADS = 512;
constexpr int BLOCK_ROWS = 32;                       // canvas rows a block
constexpr int ROW_STEP = PAINT_THREADS / CAN;        // 4
constexpr int PX = BLOCK_ROWS / ROW_STEP;            // 8 pixels a thread
constexpr int STAGE = 256;                           // paints staged at once

struct Paint {
  float x, y, w, h;
  uint8_t kind, c[3], p[3], pad;  // kind, brush/fill color, pen color
};
static_assert(sizeof(Paint) == 24, "Paint is 24 bytes (assetgen.PAINT_BYTES)");

struct Rect {
  float x, y, w, h;
};

struct Walker {
  const int64_t* v;  // the env's words
  int c, nmax;
  Paint* out;  // the env's paint list
  int n;

  __device__ uint32_t u32() {
    const uint32_t w = (uint32_t)v[c < nmax ? c : nmax - 1];
    ++c;
    return w;
  }
  __device__ float r01() { return __uint2float_rn(u32()) * 0x1p-32f; }
  __device__ int randn(uint32_t hi) { return (int)(u32() % hi); }
  __device__ int randint(int lo, int hi) {
    return lo + (int)(u32() % (uint32_t)(hi - lo));
  }
  __device__ void emit(int kind, Rect r, const float* c, const float* p) {
    Paint q;
    q.x = r.x;
    q.y = r.y;
    q.w = r.w;
    q.h = r.h;
    q.kind = (uint8_t)kind;
    for (int i = 0; i < 3; ++i) {
      q.c[i] = (uint8_t)c[i];
      q.p[i] = (uint8_t)p[i];
    }
    q.pad = 0;
    out[n++] = q;
  }
};

struct ColorGen {
  float len[3], start[3];
};

// ColorGen::roll (assetgen.cpp:10-20): 7 draws, p_rect unused
__device__ ColorGen roll(Walker& wk) {
  ColorGen g;
  for (int i = 0; i < 3; ++i) g.len[i] = wk.r01();
  for (int i = 0; i < 3; ++i) g.start[i] = wk.r01() * (1.0f - g.len[i]);
  wk.r01();
  return g;
}

// ColorGen::rand_color (cpp:22-28): 3 draws
__device__ void rand_color(Walker& wk, const ColorGen& g, float* col) {
  for (int i = 0; i < 3; ++i) {
    const float v = wk.r01();
    col[i] = floorf(255.0f * (v * g.len[i] + g.start[i]));
  }
}

// cpp:35-51 (w/h truncated to int): 4 draws
__device__ Rect choose_sub_rect(Walker& wk, Rect r, float min_dim, float max_dim) {
  const float wi = truncf(r.w), hi = truncf(r.h);
  const float smaller = wi > hi ? hi : wi;
  const float del = max_dim - min_dim;
  const float v1 = wk.r01(), v2 = wk.r01(), v3 = wk.r01(), v4 = wk.r01();
  const float rdx = (v1 * del + min_dim) * smaller;
  const float rdy = (v2 * del + min_dim) * smaller;
  const float rx_off = v3 * (wi - rdx);
  const float ry_off = v4 * (hi - rdy);
  return Rect{rx_off + r.x, ry_off + r.y, rdx, rdy};
}

// cpp:76-102
__device__ void paint_shape(Walker& wk, Rect r, const ColorGen& g) {
  const int k = wk.randn(10);
  const int num_splits = k * k / 50 + 1;
  const bool horiz = wk.r01() > 0.5f;
  const bool use_rect = wk.r01() > 0.5f;
  const bool regen = wk.r01() > 0.5f;
  float c1[3], c2[3];
  rand_color(wk, g, c1);
  rand_color(wk, g, c2);
  const float nsf = (float)num_splits;
  const float dw = r.w / nsf, dh = r.h / nsf;
  for (int i = 0; i < num_splits; ++i) {
    if (regen) {
      rand_color(wk, g, c1);
      rand_color(wk, g, c2);
    }
    // x + 0 * dw is x (canvas coordinates are never -0); x + 1 * dw
    const Rect sub = horiz ? Rect{i ? r.x + dw : r.x, r.y, dw, r.h}
                           : Rect{r.x, i ? r.y + dh : r.y, r.w, dh};
    wk.emit(use_rect ? PAINT_FILL : PAINT_ELLIPSE, sub, c1, c2);
  }
}

// cpp:104-132; num_recurse is 1 for the outer resource (blotch_scale 50)
// and 0 for an inner one (blotch_scale 10), whose recursion test
// short-circuits before its rand01
template <bool OUTER>
__device__ void paint_rect_resource(Walker& wk, Rect r) {
  const ColorGen g = roll(wk);
  float bg[3];
  rand_color(wk, g, bg);
  wk.emit(PAINT_FILL, r, bg, bg);
  const float scale = C03 + C07 * wk.r01();
  const int nb = OUTER ? wk.randint(50, 100) : wk.randint(10, 20);
  const float p_recurse = wk.r01() * C075;
  const float min_dim = C005 * scale, max_dim = C05 * scale;
  for (int j = 0; j < nb; ++j) {
    const Rect sub = choose_sub_rect(wk, r, min_dim, max_dim);
    if constexpr (OUTER) {
      if (wk.r01() < p_recurse) {
        paint_rect_resource<false>(wk, sub);
        continue;
      }
    }
    paint_shape(wk, sub, g);
  }
  wk.emit(PAINT_BLEND, r, bg, bg);
}

__global__ void __launch_bounds__(WALK_THREADS)
walk_kernel(const int64_t* __restrict__ vals, int n, int nmax, int max_paints,
            Paint* __restrict__ paints, int32_t* __restrict__ counts,
            int32_t* __restrict__ used) {
  const int e = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (e >= n) return;
  Walker wk{vals + (int64_t)e * nmax, 0, nmax, paints + (int64_t)e * max_paints, 0};
  paint_rect_resource<true>(wk, Rect{0.f, 0.f, 500.f, 500.f});
  counts[e] = wk.n;
  used[e] = wk.c;
}

__global__ void __launch_bounds__(PAINT_THREADS)
paint_kernel(const Paint* __restrict__ paints, const int32_t* __restrict__ counts,
             int max_paints, uint8_t* __restrict__ out) {
  __shared__ Paint sp[STAGE];
  const int64_t e = blockIdx.x;
  const Paint* list = paints + e * max_paints;
  const int n = counts[e];
  const int col = threadIdx.x % CAN;
  const int row0 = blockIdx.y * BLOCK_ROWS + threadIdx.x / CAN;
  const float gx = ((float)col + 0.5f) * CELL;
  float gy[PX];
  float px[PX][3];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    gy[k] = ((float)(row0 + k * ROW_STEP) + 0.5f) * CELL;
    px[k][0] = px[k][1] = px[k][2] = 0.f;
  }

  for (int base = 0; base < n; base += STAGE) {
    const int m = min(STAGE, n - base);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += PAINT_THREADS) sp[i] = list[base + i];
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const Paint q = sp[i];
      if (q.kind == PAINT_ELLIPSE) {
        const float a = fmaxf(q.w * 0.5f, EPS), b = fmaxf(q.h * 0.5f, EPS);
        const float cx = q.x + q.w * 0.5f, cy = q.y + q.h * 0.5f;
        const float dx = (gx - cx) / a;
        const float dx2 = dx * dx;
        // d2 = dy2 + dx2 >= dx2: no pixel of this column is inside
        if (!(dx2 <= 1.0f)) continue;
        const float ai = fmaxf(a - 1.0f, 0.f), bi = fmaxf(b - 1.0f, 0.f);
        const bool has_inner = ai > 0.f && bi > 0.f;
        const float dxi = (gx - cx) / fmaxf(ai, EPS);
        const float dx2i = dxi * dxi;
        const float bi_ = fmaxf(bi, EPS);
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const float dy = (gy[k] - cy) / b;
          if (dy * dy + dx2 <= 1.0f) {
            const float dyi = (gy[k] - cy) / bi_;
            const bool inner = has_inner && (dyi * dyi + dx2i <= 1.0f);
            const uint8_t* c = inner ? q.c : q.p;
            px[k][0] = (float)c[0];
            px[k][1] = (float)c[1];
            px[k][2] = (float)c[2];
          }
        }
      } else {
        if (!(gx >= q.x && gx < q.x + q.w)) continue;
        const float y1 = q.y + q.h;
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (gy[k] >= q.y && gy[k] < y1) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float col_c = (float)q.c[c];
              px[k][c] = q.kind == PAINT_FILL
                             ? col_c
                             : col_c * ALPHA + px[k][c] * ONE_MINUS_ALPHA;
            }
          }
        }
      }
    }
  }

  uint8_t* img = out + e * CAN * CAN * 3;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int64_t o = ((int64_t)(row0 + k * ROW_STEP) * CAN + col) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      img[o + c] = (uint8_t)fminf(fmaxf(rintf(px[k][c]), 0.f), 255.f);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes by procgen_tpu_torch/kernels.py).
// vals: int64 [n, nmax], uint32 words; canvas: uint8 [n, 128, 128, 3];
// used: int32 [n]; paints: scratch of chunk * max_paints 24-byte paints;
// counts: int32 [chunk] scratch.  Walks and paints ``chunk`` envs a launch
// pair.  Launches on ``stream``; returns the first cudaGetLastError() that
// is not 0, else 0.
extern "C" int assetgen_bg(const int64_t* vals, uint8_t* canvas, int32_t* used,
                           uint8_t* paints, int32_t* counts, int n, int nmax,
                           int chunk, int max_paints, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (nmax < 1 || chunk < 1 || max_paints < 2 + 99 * 40)
    return (int)cudaErrorInvalidValue;
  Paint* list = reinterpret_cast<Paint*>(paints);
  for (int e0 = 0; e0 < n; e0 += chunk) {
    const int m = n - e0 < chunk ? n - e0 : chunk;
    walk_kernel<<<(m + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0, stream>>>(
        vals + (int64_t)e0 * nmax, m, nmax, max_paints, list, counts, used + e0);
    int err = (int)cudaGetLastError();
    if (err) return err;
    paint_kernel<<<dim3((unsigned)m, CAN / BLOCK_ROWS), PAINT_THREADS, 0, stream>>>(
        list, counts, max_paints, canvas + (int64_t)e0 * CAN * CAN * 3);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
