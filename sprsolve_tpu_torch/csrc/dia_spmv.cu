// Banded (DIA) SpMV kernels for Hopper (sm_90a): K1, K2 and K3 of the port.
//
// Layout (see sprsolve_tpu_torch/ops/padded_dia.py): a vector is flat,
// h zeros | n_pad body entries | h zeros, with h >= max |offset|, n_pad a
// multiple of ROW_TILE and the body 16-byte aligned (h * sizeof(V) is a
// multiple of 16).  Bands are (D, n_pad), row-major, zero outside the
// matrix.  Band storage may be narrower than the vector type (int8 or bf16
// for f32 vectors); narrowing is exact, so widening in registers gives the
// same products bit for bit.
//
// K1  dia_spmv_kernel replaces _dia_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:131, wrapper _dia_pallas_call :509):
//     y[h + i] = sum_d widen(band[d][i]) * x[h + i + off_d].
// K2  dia_dots_kernel<.., YY = true> replaces _dia_wdot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:159, wrapper _dia_wdot_pallas_call :194):
//     K1 on u = dinv * x (HAS_DINV) or on x, and out = [sum w*y, sum y*y];
//     with W_IS_X the dot reads the raw x, as w_ref = x_ref does on the TPU.
// K1b dia_spmm_kernel replaces _dia_kernel under jax.vmap (the column-batched
//     call that sprsolve_tpu/solvers/lobpcg.py:51-54 reaches through
//     multigrid.py:259 and _dia_pallas_call :509): Y = A * X for a block of m
//     vectors, each column bit for bit K1's result on that column.
// K3  dia_dots_kernel<.., YY = false> replaces _dia_dot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:140, wrapper _dia_dotmv_pallas_call
//     :474): K1 and out = [sum x*y], with x the raw body of the SpMV input
//     (jnp.sum(x_ref[hr:hr+br] * acc) on the TPU) -- the mkl_sparse_?_dotmv
//     analog behind MINRES's and CG's alpha.
//
// What bounds them on an H100: HBM bytes.  Per row they move
// D * band_bytes + 2 * vec_bytes (K1 and K3), plus vec_bytes for dinv and
// for w (K2), at 2 flops per band: far below any compute limit.
//
// K1's design (it replaced one thread per row, 3907 blocks of 256 at 1M
// rows with a tail wave, which reached 0.309 of the bound cold): K3's tile
// without its dot.  A thread owns 4 consecutive rows of a DOT_TILE-row
// tile; the block stages the tile's x window, DOT_HALO rows on each side,
// in shared memory with one 16-byte load per thread (plus the halo quads),
// and bands with |offset| <= DOT_HALO read their shifted quads there (two
// aligned quads and a select); the others read x through L2, a vector load
// where the offset keeps 16-byte alignment.  The bands are read 4 rows at
// a time (int8 as 4 bytes, bf16 as 8, f32 as float4, f64 as two double2).
// One wave of blocks, blocks_per_sm<V>() times the SM count, walks the
// tiles; the walk also clears both halos of y, for any h <= n_pad.
// Where its threads of 4 rows would fill less than half the card's thread
// slots (fewer than 540k rows on an H100; the caller decides, quads = 0),
// K1 runs the first design's body instead, one thread per row and ROW_TILE
// rows a block: four times the warps in flight.  At the 64^3 Poisson
// (262k rows) the 4-row tiles ran 0.3-1.2 us slower warm and 0.4-1.7 us
// cold than that body (PERF.md, section 6).
// The caller picks the band loads (stream_bands): plain where a call's
// bytes (bands, x and y) fit in L2, so the next call finds the bands there;
// with the streaming hint (ld.global.cs, evict first) where they do not,
// as nothing of one call then stays for the next, and streaming the bands
// keeps x in L2 for the far offsets.  The shapes timed on each side of
// that line, both ways (PERF.md, section 6): the 100^3 Poisson in f64
// (72 MB a call: streamed faster warm and cold) and with f32 bands (36 MB:
// streamed slower warm, faster cold), and the 64^3 Poisson.
// Each row sums over the bands in order d = 0 .. nd - 1 as
// acc = fma(widen(band), x, acc) from 0, spelled out (madd), so y does not
// depend on the compiler's contraction; K1b, K2 and K3 sum the same way,
// so their y is K1's bit for bit.  No dot, so no ticket or scratch.
// Tried on the H100 and slower at every band storage (PERF.md, section 6):
// a ring of 2 stages of each tile's x window and band rows in shared
// memory, filled by cp.async.bulk from one producer warp with mbarriers
// (the Hopper path: no registers spent on addresses); with one tile a
// block, its two waits a tile add latency that nothing hides.
//
// K1b's design: the block is row-major, (h + n_pad + h, m): row r of the
// padded layout holds entry r of every column, so a column is a strided
// padded vector and the m entries of a row are adjacent.  A thread owns a
// group of W adjacent columns of one row (W = 4 f32 or 2 f64 entries, one
// 16-byte access, where W divides m; else 2 or 1), SPMM_THREADS groups per
// tile, a grid-stride walk over the tiles by one wave of blocks (as many as
// share an SM, by the runtime's occupancy count, times the SM count the
// caller passes; the result does not depend on the grid).  Per band it loads the band
// element once and applies it to its W columns; the threads of a row load
// it from one address (a broadcast), so each band element is read from
// memory once per row.  X's shifted reads X[h + i + off_d][j..j+W) and Y's
// writes are whole 16-byte accesses, coalesced across the warp.  Each
// entry sums over the bands in K1's order with K1's fma (madd), so column j
// equals K1 on column j bit for bit.  The walk also clears the h
// halo rows at each end.  HBM bytes: the bands once plus m * (x + y).
// A first version with one entry per thread ran at 0.21 of this bound,
// slower than m K1 calls (PERF.md, section 6): per entry it issued as many
// loads as K1 issues per row.
//
// K2 and K3 (dia_dots_kernel) answer what held their first versions back:
//  * One launch, deterministic.  A block sums each tile's dots in a fixed
//    tree (block_sum) and writes one partial per tile and dot to a scratch
//    area; then __threadfence and an integer atomicAdd on a ticket tell the
//    last block to finish.  That block sums the partials in tile order
//    (thread t takes partials t, t + DOT_THREADS, ..., then block_sum), so
//    the result depends neither on which block came last nor on the grid
//    (which follows the card's SM count), writes out[] and
//    resets the ticket to 0 -- the kernel replays inside a CUDA graph.  No
//    float atomics: a solve's iteration count does not change from run to
//    run, and narrow bands give the dots of wide ones bit for bit.  The
//    wrapper keeps one scratch area per (device, stream).
//  * The Jacobi fold once per element.  A block stages its tile's window,
//    DOT_HALO rows on each side, in shared memory as u = x * dinv (or x),
//    so each element's product is formed once, not once per band.  Bands
//    with |offset| <= DOT_HALO read u there; the others read x (and dinv)
//    from L2 and multiply in registers.  Either way u is the rounded product
//    that K1 would take as its input, so y equals K1(u) bit for bit.  The
//    staging is an ordinary vector load, multiply and shared store.
//  * More bytes per load.  A thread owns 4 consecutive rows: int8 bands are
//    read as 4 bytes, bf16 as 8, f32 as float4, f64 as two double2; the x
//    body, w and y as float4 (two double2 in f64).  A shifted read whose
//    offset is not a multiple of 4 takes two aligned quads from shared
//    memory and selects; one beyond the window takes a vector load when the
//    offset keeps 16-byte alignment and scalar loads otherwise.
//  * A grid that fits the card.  Every variant is held to the registers
//    that let blocks_per_sm<V>() blocks (8 in f32, 2048 threads) share an
//    SM, and the wrapper launches min(tiles, that many blocks per SM) blocks;
//    each walks tiles blockIdx.x, + gridDim.x, ...: one wave, no tail.  (A
//    second wave of a few blocks, where a variant had more than 32
//    registers, cost K3 about a microsecond.)
// Tried on the H100 and slower (PERF.md, section 6): issuing every global read
// of a tile as cp.async before the first wait (57-92 registers, fewer
// blocks per SM); and the first K1's one row per thread, 3907 blocks, with
// the same ticket (the 3907 atomicAdds on one counter cost K3 some 7 us).
// The launchers allocate nothing and never synchronise; they launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ROW_TILE 256
#define MAX_DIAGS 32
#define DOT_THREADS 256                 // threads of a K2/K3 block
#define DOT_TILE (4 * DOT_THREADS)      // rows of a K2/K3 tile, 4 per thread
#define DOT_HALO 128                    // staged rows on each side of a tile
#define SCRATCH_HEAD 256                // scratch bytes before the partials
#define SPMM_THREADS 256                // threads of a K1b block: one tile
#define SPMM_MAX_ENTRIES 0x7fffff00LL   // K1b blocks hold fewer entries

// K1-K3 blocks that share an SM: 8 (all its 2048 threads) in f32, where the
// kernels fit 32 registers; 4 in f64
template <typename V>
__host__ __device__ constexpr int blocks_per_sm() { return sizeof(V) == 4 ? 8 : 4; }

static_assert(DOT_THREADS == ROW_TILE, "block_sum sums ROW_TILE threads");

namespace {

struct Offsets {
  long long off[MAX_DIAGS];
  int nd;
};

template <typename V, typename B>
__device__ __forceinline__ V widen(B b) {
  return static_cast<V>(b);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 b) {
  return __bfloat162float(b);
}

// acc + b * x rounded once: the one expression every SpMV here sums with
__device__ __forceinline__ float madd(float b, float x, float acc) { return __fmaf_rn(b, x, acc); }
__device__ __forceinline__ double madd(double b, double x, double acc) { return __fma_rn(b, x, acc); }

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per thread over a ROW_TILE block, in a fixed tree: warp
// shuffles, then the first warp over the per-warp sums in shared memory
// (smem holds ROW_TILE / 32 values).  The block's sum is valid in thread 0.
// Every thread of the block must call it.  fused.cu keeps a copy, so that
// each source builds alone.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = V(0);
  if (warp == 0) {
    v = lane < ROW_TILE / 32 ? smem[lane] : V(0);
    v = warp_sum(v);
  }
  return v;
}

// K1 on few rows (see the header): one thread per row, ROW_TILE rows a
// block; the first h threads clear both halos (h <= n_pad)
template <typename V, typename B>
__global__ void __launch_bounds__(ROW_TILE)
dia_spmv_kernel_rows(const B* __restrict__ bands, const V* __restrict__ x,
                     V* __restrict__ y, long long n_pad, long long h, Offsets offs) {
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const V* xi = x + h + i;
  V acc = V(0);
#pragma unroll
  for (int d = 0; d < MAX_DIAGS; ++d) {
    if (d >= offs.nd) break;
    acc = madd(widen<V>(bands[(long long)d * n_pad + i]), xi[offs.off[d]], acc);
  }
  y[h + i] = acc;
  if (i < h) {
    y[i] = V(0);
    y[h + n_pad + i] = V(0);
  }
}

// --- K1b ---------------------------------------------------------------------
// W entries of V as one access: 16 bytes for float4 / double2
template <typename V, int W>
struct Group {
  V v[W];
};

template <typename V, int W>
__device__ __forceinline__ Group<V, W> ld_group(const V* p) {
  Group<V, W> g;
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    g.v[0] = t.x; g.v[1] = t.y; g.v[2] = t.z; g.v[3] = t.w;
  } else if constexpr (W == 2 && sizeof(V) == 4) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    g.v[0] = t.x; g.v[1] = t.y;
  } else if constexpr (W == 2) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    g.v[0] = t.x; g.v[1] = t.y;
  } else {
    g.v[0] = *p;
  }
  return g;
}

template <typename V, int W>
__device__ __forceinline__ void st_group(V* p, const Group<V, W>& g) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(g.v[0], g.v[1], g.v[2], g.v[3]);
  } else if constexpr (W == 2 && sizeof(V) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(g.v[0], g.v[1]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(g.v[0], g.v[1]);
  } else {
    *p = g.v[0];
  }
}

// Indices are 32-bit (a 32-bit division finds the row): the launcher takes
// blocks of fewer than SPMM_MAX_ENTRIES entries, so no index of the walk
// (at most twice that) passes 2^32.
template <typename V, typename B, int W>
__global__ void __launch_bounds__(SPMM_THREADS)
dia_spmm_kernel(const B* __restrict__ bands, const V* __restrict__ x,
                V* __restrict__ y, long long n_pad, long long h, long long m,
                Offsets offs) {
  using IDX = unsigned;
  const IDX groups = (IDX)(m / W);            // column groups of a row
  const IDX body = (IDX)n_pad * groups;
  const IDX stride = (IDX)gridDim.x * SPMM_THREADS;
  const IDX first = (IDX)blockIdx.x * SPMM_THREADS + threadIdx.x;
  const V* __restrict__ xb = x + h * m;
  V* __restrict__ yb = y + h * m;
  for (IDX g = first; g < body; g += stride) {
    const IDX i = g / groups;
    const long long e = (long long)g * W;       // = i * m + W * (g % groups)
    Group<V, W> acc;
#pragma unroll
    for (int w = 0; w < W; ++w) acc.v[w] = V(0);
#pragma unroll
    for (int d = 0; d < MAX_DIAGS; ++d) {
      if (d >= offs.nd) break;
      const V b = widen<V>(bands[(long long)d * n_pad + i]);
      const Group<V, W> xv = ld_group<V, W>(xb + e + offs.off[d] * m);
#pragma unroll
      for (int w = 0; w < W; ++w) acc.v[w] = madd(b, xv.v[w], acc.v[w]);
    }
    st_group<V, W>(yb + e, acc);
  }
  const IDX halo = (IDX)(h * m);
  for (IDX e = first; e < halo; e += stride) {
    y[e] = V(0);
    yb[(long long)n_pad * m + e] = V(0);
  }
}

// --- K1, K2 and K3 ----------------------------------------------------------
// Four consecutive entries; VW of them fill one 16-byte access.
template <typename V>
struct Quad {
  V v[4];
};

template <typename V>
__host__ __device__ constexpr int vec_width() { return 16 / (int)sizeof(V); }

__device__ __forceinline__ Quad<float> ld_quad(const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ Quad<double> ld_quad(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {{a.x, a.y, b.x, b.y}};
}

__device__ __forceinline__ void st_quad(float* p, const Quad<float>& q) {
  *reinterpret_cast<float4*>(p) = make_float4(q.v[0], q.v[1], q.v[2], q.v[3]);
}

__device__ __forceinline__ void st_quad(double* p, const Quad<double>& q) {
  reinterpret_cast<double2*>(p)[0] = make_double2(q.v[0], q.v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(q.v[2], q.v[3]);
}

// the quad at p[0..3], p 16-byte aligned when `aligned`, else any entry
template <typename V>
__device__ __forceinline__ Quad<V> ld_quad_any(const V* p, bool aligned) {
  if (aligned) return ld_quad(p);
  return {{p[0], p[1], p[2], p[3]}};
}

// the quad at v[g..g+3] of a vector of len entries (g a multiple of VW),
// with zeros for the 16-byte pieces that lie outside it
template <typename V>
__device__ __forceinline__ Quad<V> ld_quad_clamped(const V* v, long long g,
                                                   long long len) {
  constexpr int VW = vec_width<V>();
  Quad<V> q;
#pragma unroll
  for (int j = 0; j < 4; j += VW) {
    const long long k = g + j;
    const bool in = k >= 0 && k < len;
#pragma unroll
    for (int r = 0; r < VW; ++r) q.v[j + r] = V(0);
    if (in) {
      if constexpr (VW == 4) {
        q = ld_quad(v + k);
      } else {
        const double2 t = *reinterpret_cast<const double2*>(v + k);
        q.v[j] = (V)t.x;
        q.v[j + 1] = (V)t.y;
      }
    }
  }
  return q;
}

// the quad s[k..k+3] of the staged window (s 16-byte aligned), from the
// one or two aligned quads that hold it; a = k & 3 is the same for every
// thread of the block, so the branches do not diverge
template <typename V>
__device__ __forceinline__ Quad<V> lds_quad(const V* s, int k) {
  const int a = k & 3;
  const Quad<V> lo = ld_quad(s + (k - a));
  if (a == 0) return lo;
  const Quad<V> hi = ld_quad(s + (k - a) + 4);
  const V t[8] = {lo.v[0], lo.v[1], lo.v[2], lo.v[3],
                  hi.v[0], hi.v[1], hi.v[2], hi.v[3]};
  Quad<V> q;
#pragma unroll
  for (int r = 0; r < 4; ++r) q.v[r] = a == 1 ? t[r + 1] : a == 2 ? t[r + 2] : t[r + 3];
  return q;
}

// *p, with the streaming hint (ld.global.cs, evict first) when STREAM
template <bool STREAM, typename T>
__device__ __forceinline__ T ld_hint(const T* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return *p;
}

// four widened band values of rows i..i+3 (p 4-element aligned)
template <bool STREAM = false>
__device__ __forceinline__ Quad<float> ld_band_quad(const int8_t* p) {
  const char4 c = ld_hint<STREAM>(reinterpret_cast<const char4*>(p));
  return {{widen<float>((int8_t)c.x), widen<float>((int8_t)c.y),
           widen<float>((int8_t)c.z), widen<float>((int8_t)c.w)}};
}

template <bool STREAM = false>
__device__ __forceinline__ Quad<float> ld_band_quad(const __nv_bfloat16* p) {
  const uint2 raw = ld_hint<STREAM>(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return {{widen<float>(lo.x), widen<float>(lo.y), widen<float>(hi.x),
           widen<float>(hi.y)}};
}

template <bool STREAM = false>
__device__ __forceinline__ Quad<float> ld_band_quad(const float* p) {
  const float4 t = ld_hint<STREAM>(reinterpret_cast<const float4*>(p));
  return {{t.x, t.y, t.z, t.w}};
}

template <bool STREAM = false>
__device__ __forceinline__ Quad<double> ld_band_quad(const double* p) {
  const double2 a = ld_hint<STREAM>(reinterpret_cast<const double2*>(p));
  const double2 b = ld_hint<STREAM>(reinterpret_cast<const double2*>(p) + 1);
  return {{a.x, a.y, b.x, b.y}};
}

// K1: y = A·x, the band sums of K3 with no dot (see the header); STREAM:
// the band loads carry the streaming hint
template <typename V, typename B, bool STREAM>
__global__ void __launch_bounds__(DOT_THREADS, blocks_per_sm<V>())
dia_spmv_kernel(const B* __restrict__ bands, const V* __restrict__ x,
                V* __restrict__ y, long long n_pad, long long h, Offsets offs) {
  __shared__ __align__(16) V s_x[DOT_TILE + 2 * DOT_HALO];
  constexpr int VW = vec_width<V>();
  const int t = threadIdx.x;
  const long long len = n_pad + 2 * h;
  const long long n_tiles = (n_pad + DOT_TILE - 1) / DOT_TILE;
  const long long stride = (long long)gridDim.x * DOT_THREADS;
  for (long long k = (long long)blockIdx.x * DOT_THREADS + t; k < h; k += stride) {
    y[k] = V(0);
    y[h + n_pad + k] = V(0);
  }
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * DOT_TILE;
    const long long i = r0 + 4 * t;  // this thread's rows: i .. i + 3
    // stage the window rows r0 - DOT_HALO .. r0 + DOT_TILE + DOT_HALO: each
    // thread its own quad, and 2 * DOT_HALO / 4 threads one halo quad each
    st_quad(s_x + DOT_HALO + 4 * t, ld_quad_clamped(x, h + i, len));
    if (t < DOT_HALO / 2) {
      const int q = t < DOT_HALO / 4 ? t : DOT_TILE / 4 + t;
      st_quad(s_x + 4 * q, ld_quad_clamped(x, h + r0 - DOT_HALO + 4LL * q, len));
    }
    __syncthreads();
    if (i < n_pad) {  // n_pad is a multiple of 4: the quad is whole
      Quad<V> acc = {{V(0), V(0), V(0), V(0)}};
#pragma unroll
      for (int d = 0; d < MAX_DIAGS; ++d) {
        if (d >= offs.nd) break;
        const long long o = offs.off[d];
        const Quad<V> b =
            ld_band_quad<STREAM>(bands + (long long)d * n_pad + i);
        const Quad<V> xq = o >= -DOT_HALO && o <= DOT_HALO
                               ? lds_quad(s_x, DOT_HALO + 4 * t + (int)o)
                               : ld_quad_any(x + h + i + o, o % VW == 0);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc.v[r] = madd(b.v[r], xq.v[r], acc.v[r]);
      }
      st_quad(y + h + i, acc);
    }
    __syncthreads();  // the tile's reads of s_x end before the next restages it
  }
}

// K2 (YY) and K3 (!YY): y = A·u with u = dinv * x (HAS_DINV) or x, and
// out = [sum w*y, sum y*y] or [sum x*y], w read from the raw x (W_IS_X).
// scratch: a ticket (unsigned, 0 between launches) at ticket, and
// (YY ? 2 : 1) * n_tiles partials.
template <typename V, typename B, bool HAS_DINV, bool W_IS_X, bool YY>
__global__ void __launch_bounds__(DOT_THREADS, blocks_per_sm<V>())
dia_dots_kernel(const B* __restrict__ bands, const V* __restrict__ x,
                const V* __restrict__ dinv, const V* __restrict__ w,
                V* __restrict__ y, V* __restrict__ out, V* __restrict__ partials,
                unsigned* __restrict__ ticket, long long n_pad, long long h,
                Offsets offs) {
  __shared__ __align__(16) V s_u[DOT_TILE + 2 * DOT_HALO];
  __shared__ V s_w[DOT_THREADS / 32];
  __shared__ V s_y[DOT_THREADS / 32];
  __shared__ bool s_last;
  constexpr int VW = vec_width<V>();
  const int t = threadIdx.x;
  const long long len = n_pad + 2 * h;
  const long long n_tiles = (n_pad + DOT_TILE - 1) / DOT_TILE;
  const long long stride = (long long)gridDim.x * DOT_THREADS;
  for (long long k = (long long)blockIdx.x * DOT_THREADS + t; k < h; k += stride) {
    y[k] = V(0);
    y[h + n_pad + k] = V(0);
  }
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * DOT_TILE;
    const long long i = r0 + 4 * t;  // this thread's rows: i .. i + 3
    // stage the window rows r0 - DOT_HALO .. r0 + DOT_TILE + DOT_HALO as u:
    // each thread its own quad, kept raw in xo, and 2 * DOT_HALO / 4 threads
    // one halo quad each
    const Quad<V> xo = ld_quad_clamped(x, h + i, len);
    Quad<V> u = xo;
    if (HAS_DINV) {
      const Quad<V> d = ld_quad_clamped(dinv, h + i, len);
#pragma unroll
      for (int r = 0; r < 4; ++r) u.v[r] = xo.v[r] * d.v[r];
    }
    st_quad(s_u + DOT_HALO + 4 * t, u);
    if (t < DOT_HALO / 2) {
      const int q = t < DOT_HALO / 4 ? t : DOT_TILE / 4 + t;
      const long long g = h + r0 - DOT_HALO + 4LL * q;
      Quad<V> e = ld_quad_clamped(x, g, len);
      if (HAS_DINV) {
        const Quad<V> d = ld_quad_clamped(dinv, g, len);
#pragma unroll
        for (int r = 0; r < 4; ++r) e.v[r] = e.v[r] * d.v[r];
      }
      st_quad(s_u + 4 * q, e);
    }
    __syncthreads();
    V pw = V(0), py = V(0);
    if (i < n_pad) {  // n_pad is a multiple of 4: the quad is whole
      Quad<V> acc = {{V(0), V(0), V(0), V(0)}};
#pragma unroll
      for (int d = 0; d < MAX_DIAGS; ++d) {
        if (d >= offs.nd) break;
        const long long o = offs.off[d];
        const Quad<V> b = ld_band_quad(bands + (long long)d * n_pad + i);
        Quad<V> ud;
        if (o >= -DOT_HALO && o <= DOT_HALO) {
          ud = lds_quad(s_u, DOT_HALO + 4 * t + (int)o);
        } else {
          const bool aligned = o % VW == 0;
          ud = ld_quad_any(x + h + i + o, aligned);
          if (HAS_DINV) {
            const Quad<V> dq = ld_quad_any(dinv + h + i + o, aligned);
#pragma unroll
            for (int r = 0; r < 4; ++r) ud.v[r] = ud.v[r] * dq.v[r];
          }
        }
        // K1's fma, so that y is K1(u) bit for bit
#pragma unroll
        for (int r = 0; r < 4; ++r) acc.v[r] = madd(b.v[r], ud.v[r], acc.v[r]);
      }
      st_quad(y + h + i, acc);
      const Quad<V> wq = W_IS_X ? xo : ld_quad(w + h + i);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pw = pw + wq.v[r] * acc.v[r];
        if (YY) py = py + acc.v[r] * acc.v[r];
      }
    }
    // block_sum's barrier also ends this tile's reads of s_u before the
    // next tile restages it
    pw = block_sum(pw, s_w);
    if (YY) py = block_sum(py, s_y);
    if (t == 0) {
      partials[tile] = pw;
      if (YY) partials[n_tiles + tile] = py;
    }
  }
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every partial is in L2 (read past L1 with __ldcg); sum
  // them in tile order
  V sw = V(0), sy = V(0);
  for (long long k = t; k < n_tiles; k += DOT_THREADS) {
    sw = sw + __ldcg(partials + k);
    if (YY) sy = sy + __ldcg(partials + n_tiles + k);
  }
  sw = block_sum(sw, s_w);
  if (YY) sy = block_sum(sy, s_y);
  if (t == 0) {
    out[0] = sw;
    if (YY) out[1] = sy;
    *ticket = 0u;
  }
}

Offsets make_offsets(const long long* offsets, int nd) {
  Offsets o;
  o.nd = nd;
  for (int d = 0; d < MAX_DIAGS; ++d) o.off[d] = d < nd ? offsets[d] : 0;
  return o;
}

// K1: one wave of blocks_per_sm<V>() blocks an SM, at most one per tile;
// without quads, one thread per row
template <typename V, typename B>
void launch_spmv(const void* bands, const void* x, void* y, long long n_pad,
                 long long h, const Offsets& o, int sm_count, bool stream_bands,
                 bool quads, cudaStream_t s) {
  if (!quads) {
    dia_spmv_kernel_rows<V, B><<<(unsigned)(n_pad / ROW_TILE), ROW_TILE, 0, s>>>(
        (const B*)bands, (const V*)x, (V*)y, n_pad, h, o);
    return;
  }
  const long long tiles = (n_pad + DOT_TILE - 1) / DOT_TILE;
  const long long wave = (long long)blocks_per_sm<V>() * sm_count;
  const unsigned grid = (unsigned)(tiles < wave ? tiles : wave);
  if (stream_bands)
    dia_spmv_kernel<V, B, true><<<grid, DOT_THREADS, 0, s>>>(
        (const B*)bands, (const V*)x, (V*)y, n_pad, h, o);
  else
    dia_spmv_kernel<V, B, false><<<grid, DOT_THREADS, 0, s>>>(
        (const B*)bands, (const V*)x, (V*)y, n_pad, h, o);
}

// the columns a K1b thread takes: a 16-byte group where it divides m and
// the blocks are 16-byte aligned, else 8 bytes, else one entry
template <typename V>
int spmm_width(long long m, const void* x, const void* y) {
  const bool aligned = (((uintptr_t)x | (uintptr_t)y) & 15u) == 0;
  if (sizeof(V) == 4 && aligned && m % 4 == 0) return 4;
  if (aligned && m % 2 == 0) return 2;
  return 1;
}

// K1b blocks of the instantiation W that share an SM, asked of the runtime
// once
template <typename V, typename B, int W>
int spmm_blocks_per_sm() {
  static const int n = [] {
    int k = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, dia_spmm_kernel<V, B, W>,
                                                  SPMM_THREADS, 0);
    return k > 0 ? k : 1;
  }();
  return n;
}

template <typename V, typename B, int W>
void launch_spmm_w(const void* bands, const void* x, void* y, long long n_pad,
                   long long h, long long m, const Offsets& o, int sm_count,
                   cudaStream_t s) {
  const long long tiles = (n_pad * (m / W) + SPMM_THREADS - 1) / SPMM_THREADS;
  const long long wave = (long long)spmm_blocks_per_sm<V, B, W>() * sm_count;
  dia_spmm_kernel<V, B, W><<<(unsigned)(tiles < wave ? tiles : wave), SPMM_THREADS, 0, s>>>(
      (const B*)bands, (const V*)x, (V*)y, n_pad, h, m, o);
}

template <typename V, typename B>
void launch_spmm(const void* bands, const void* x, void* y, long long n_pad,
                 long long h, long long m, const Offsets& o, int sm_count,
                 cudaStream_t s) {
  const int w = spmm_width<V>(m, x, y);
  if (w == 4)
    launch_spmm_w<V, B, (sizeof(V) == 4 ? 4 : 2)>(bands, x, y, n_pad, h, m, o, sm_count, s);
  else if (w == 2)
    launch_spmm_w<V, B, 2>(bands, x, y, n_pad, h, m, o, sm_count, s);
  else
    launch_spmm_w<V, B, 1>(bands, x, y, n_pad, h, m, o, sm_count, s);
}

struct DotArgs {
  const void *bands, *x, *dinv, *w;
  void *y, *out, *scratch;
  long long scratch_bytes;
  int grid;
  long long n_pad, h;
  Offsets o;
  cudaStream_t s;
};

template <typename V, typename B, bool HAS_DINV, bool W_IS_X, bool YY>
int dots_op(const DotArgs& a) {
  char* sc = (char*)a.scratch;
  dia_dots_kernel<V, B, HAS_DINV, W_IS_X, YY><<<a.grid, DOT_THREADS, 0, a.s>>>(
      (const B*)a.bands, (const V*)a.x, (const V*)a.dinv, (const V*)a.w,
      (V*)a.y, (V*)a.out, (V*)(sc + SCRATCH_HEAD), (unsigned*)sc, a.n_pad,
      a.h, a.o);
  return (int)cudaGetLastError();
}

// kind 0: K3; 1-4: K2 with kind = 1 + 2 * has_dinv + w_is_x.  -1: no such kind.
template <typename V, typename B>
int dots_kind(int kind, const DotArgs& a) {
  switch (kind) {
    case 0: return dots_op<V, B, false, true, false>(a);
    case 1: return dots_op<V, B, false, false, true>(a);
    case 2: return dots_op<V, B, false, true, true>(a);
    case 3: return dots_op<V, B, true, false, true>(a);
    case 4: return dots_op<V, B, true, true, true>(a);
    default: return -1;
  }
}

int dots(int vcode, int bcode, int kind, const DotArgs& a) {
  if (vcode == 0 && bcode == 0) return dots_kind<float, float>(kind, a);
  if (vcode == 0 && bcode == 1) return dots_kind<float, __nv_bfloat16>(kind, a);
  if (vcode == 0 && bcode == 2) return dots_kind<float, int8_t>(kind, a);
  if (vcode == 1 && bcode == 0) return dots_kind<double, double>(kind, a);
  return -1;
}

bool bad_geometry(long long n_pad, long long h, int nd) {
  return nd < 0 || nd > MAX_DIAGS || n_pad <= 0 || n_pad % ROW_TILE != 0 ||
         h < 0 || h > n_pad || n_pad / ROW_TILE > 0x7fffffffLL;
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15u) != 0; }

int launch_dots(int vcode, int bcode, int kind, DotArgs& a,
                const long long* offsets, int nd) {
  const long long vbytes = vcode == 1 ? 8 : 4;
  const long long n_tiles = (a.n_pad + DOT_TILE - 1) / DOT_TILE;
  if (bad_geometry(a.n_pad, a.h, nd) || a.grid < 1 ||
      a.scratch_bytes < SCRATCH_HEAD + 2 * n_tiles * vbytes)
    return (int)cudaErrorInvalidValue;
  if (misaligned(a.bands) || misaligned(a.x) || misaligned(a.dinv) ||
      misaligned(a.w) || misaligned(a.y) || misaligned(a.scratch) ||
      (a.h * vbytes) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  a.o = make_offsets(offsets, nd);
  const int err = dots(vcode, bcode, kind, a);
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

}  // namespace

// Type codes: vcode 0 = f32, 1 = f64 vectors; bcode 0 = bands of the vector
// type, 1 = bf16, 2 = int8 (both for f32 vectors only).

extern "C" int sprsolve_dia_row_tile() { return ROW_TILE; }

extern "C" int sprsolve_dia_max_diags() { return MAX_DIAGS; }

extern "C" int sprsolve_dia_dots_tile() { return DOT_TILE; }

extern "C" int sprsolve_dia_dots_scratch_head() { return SCRATCH_HEAD; }

extern "C" const char* sprsolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1.  x, y and the bands 16-byte aligned; quads: 1 for the tiles of 4
// rows a thread, 0 for one thread per row; sm_count: the SMs the tiles'
// one wave of blocks fills; stream_bands: 1 to load the tiles' bands with
// the streaming hint (y depends on none of the three).
extern "C" int sprsolve_dia_spmv(int vcode, int bcode, const void* bands,
                                 const void* x, void* y, long long n_pad,
                                 long long h, const long long* offsets, int nd,
                                 int quads, int sm_count, int stream_bands,
                                 void* stream) {
  if (bad_geometry(n_pad, h, nd) || sm_count < 1) return (int)cudaErrorInvalidValue;
  if (misaligned(bands) || misaligned(x) || misaligned(y) ||
      (h * (vcode == 1 ? 8 : 4)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Offsets o = make_offsets(offsets, nd);
  cudaStream_t s = (cudaStream_t)stream;
  const bool sb = stream_bands != 0, q = quads != 0;
  if (vcode == 0 && bcode == 0) launch_spmv<float, float>(bands, x, y, n_pad, h, o, sm_count, sb, q, s);
  else if (vcode == 0 && bcode == 1) launch_spmv<float, __nv_bfloat16>(bands, x, y, n_pad, h, o, sm_count, sb, q, s);
  else if (vcode == 0 && bcode == 2) launch_spmv<float, int8_t>(bands, x, y, n_pad, h, o, sm_count, sb, q, s);
  else if (vcode == 1 && bcode == 0) launch_spmv<double, double>(bands, x, y, n_pad, h, o, sm_count, sb, q, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int sprsolve_dia_spmm_threads() { return SPMM_THREADS; }

// the columns one K1b thread takes, by vector type code (see spmm_width)
extern "C" int sprsolve_dia_spmm_width(int vcode, long long m, const void* x,
                                       const void* y) {
  return vcode == 1 ? spmm_width<double>(m, x, y) : spmm_width<float>(m, x, y);
}

// K1b.  x and y: row-major (h + n_pad + h, m) blocks of fewer than
// SPMM_MAX_ENTRIES entries, x's halo rows zero.  sm_count: the SMs the
// launch's one wave of blocks fills (at most one block per tile).
extern "C" int sprsolve_dia_spmm(int vcode, int bcode, const void* bands,
                                 const void* x, void* y, long long n_pad,
                                 long long h, long long m,
                                 const long long* offsets, int nd, int sm_count,
                                 void* stream) {
  if (bad_geometry(n_pad, h, nd) || m < 1 || sm_count < 1 ||
      m >= SPMM_MAX_ENTRIES / (n_pad + 2 * h))
    return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0 && bcode == 0) launch_spmm<float, float>(bands, x, y, n_pad, h, m, o, sm_count, s);
  else if (vcode == 0 && bcode == 1) launch_spmm<float, __nv_bfloat16>(bands, x, y, n_pad, h, m, o, sm_count, s);
  else if (vcode == 0 && bcode == 2) launch_spmm<float, int8_t>(bands, x, y, n_pad, h, m, o, sm_count, s);
  else if (vcode == 1 && bcode == 0) launch_spmm<double, double>(bands, x, y, n_pad, h, m, o, sm_count, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K2/K3 blocks that share an SM, by vector type code
extern "C" int sprsolve_dia_dots_blocks_per_sm(int vcode) {
  return vcode == 1 ? blocks_per_sm<double>() : blocks_per_sm<float>();
}

// K2.  dinv == nullptr: no Jacobi fold; w == nullptr: the dot reads x
// (w_is_x).  out: 2 values, [w.y, y.y].  scratch: the caller's per-stream
// area of scratch_bytes >= SCRATCH_HEAD + 2 * tiles * sizeof(V) bytes,
// zero before its first launch (each launch leaves the ticket so).  grid:
// at least 1 block; the dots do not depend on it.
extern "C" int sprsolve_dia_wdot(int vcode, int bcode, const void* bands,
                                 const void* x, const void* dinv, const void* w,
                                 void* y, void* out, void* scratch,
                                 long long scratch_bytes, int grid,
                                 long long n_pad, long long h,
                                 const long long* offsets, int nd, void* stream) {
  DotArgs a{bands, x, dinv, w, y, out, scratch, scratch_bytes, grid, n_pad, h, {},
            (cudaStream_t)stream};
  const int kind = 1 + 2 * (dinv != nullptr) + (w == nullptr);
  return launch_dots(vcode, bcode, kind, a, offsets, nd);
}

// K3.  out: 1 value, x.y; scratch and grid as for sprsolve_dia_wdot.
extern "C" int sprsolve_dia_dot(int vcode, int bcode, const void* bands,
                                const void* x, void* y, void* out, void* scratch,
                                long long scratch_bytes, int grid, long long n_pad,
                                long long h, const long long* offsets, int nd,
                                void* stream) {
  DotArgs a{bands, x, nullptr, nullptr, y, out, scratch, scratch_bytes, grid, n_pad,
            h, {}, (cudaStream_t)stream};
  return launch_dots(vcode, bcode, 0, a, offsets, nd);
}
