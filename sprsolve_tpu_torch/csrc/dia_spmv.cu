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
// K1's design: one thread per row, ROW_TILE rows per block, every band row,
// the x body and y read and written coalesced; the D shifted reads of x are
// served from L1/L2, so x costs about one HBM pass; the offsets live in the
// kernel's parameter space and the band loop is unrolled to MAX_DIAGS with
// an early exit, so no offset is indexed dynamically.
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
// blocks per SM); and K1's one row per thread, 3907 blocks, with the same
// ticket (the 3907 atomicAdds on one counter cost K3 some 7 us).
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

// K2/K3 blocks that share an SM: 8 (all its 2048 threads) in f32, where the
// kernel fits 32 registers; 4 in f64
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

// sum over the band loop for one row; xi points at row i's body entry
template <typename V, typename B>
__device__ __forceinline__ V band_accumulate(const B* __restrict__ bands,
                                             const V* __restrict__ xi,
                                             long long i, long long n_pad,
                                             const Offsets& offs) {
  V acc = V(0);
#pragma unroll
  for (int d = 0; d < MAX_DIAGS; ++d) {
    if (d >= offs.nd) break;
    acc = acc + widen<V>(bands[(long long)d * n_pad + i]) * xi[offs.off[d]];
  }
  return acc;
}

template <typename V, typename B>
__global__ void __launch_bounds__(ROW_TILE)
dia_spmv_kernel(const B* __restrict__ bands, const V* __restrict__ x,
                V* __restrict__ y, long long n_pad, long long h, Offsets offs) {
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  y[h + i] = band_accumulate<V, B>(bands, x + h + i, i, n_pad, offs);
  if (i < h) {  // h <= n_pad: the first h threads clear both halos
    y[i] = V(0);
    y[h + n_pad + i] = V(0);
  }
}

// --- K2 and K3 ---------------------------------------------------------------
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

// four widened band values of rows i..i+3 (p 4-element aligned)
template <typename V, typename B>
__device__ __forceinline__ Quad<V> ld_band_quad(const B* p);

template <>
__device__ __forceinline__ Quad<float> ld_band_quad<float, int8_t>(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return {{widen<float>((int8_t)c.x), widen<float>((int8_t)c.y),
           widen<float>((int8_t)c.z), widen<float>((int8_t)c.w)}};
}

template <>
__device__ __forceinline__ Quad<float> ld_band_quad<float, __nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return {{widen<float>(lo.x), widen<float>(lo.y), widen<float>(hi.x),
           widen<float>(hi.y)}};
}

template <>
__device__ __forceinline__ Quad<float> ld_band_quad<float, float>(const float* p) {
  return ld_quad(p);
}

template <>
__device__ __forceinline__ Quad<double> ld_band_quad<double, double>(const double* p) {
  return ld_quad(p);
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
        const Quad<V> b = ld_band_quad<V, B>(bands + (long long)d * n_pad + i);
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
        // K1's expression, so that y is K1(u) bit for bit
#pragma unroll
        for (int r = 0; r < 4; ++r) acc.v[r] = acc.v[r] + b.v[r] * ud.v[r];
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

template <typename V, typename B>
void launch_spmv(const void* bands, const void* x, void* y, long long n_pad,
                 long long h, const Offsets& o, cudaStream_t s) {
  dia_spmv_kernel<V, B><<<(unsigned)(n_pad / ROW_TILE), ROW_TILE, 0, s>>>(
      (const B*)bands, (const V*)x, (V*)y, n_pad, h, o);
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

extern "C" int sprsolve_dia_spmv(int vcode, int bcode, const void* bands,
                                 const void* x, void* y, long long n_pad,
                                 long long h, const long long* offsets, int nd,
                                 void* stream) {
  if (bad_geometry(n_pad, h, nd)) return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0 && bcode == 0) launch_spmv<float, float>(bands, x, y, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 1) launch_spmv<float, __nv_bfloat16>(bands, x, y, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 2) launch_spmv<float, int8_t>(bands, x, y, n_pad, h, o, s);
  else if (vcode == 1 && bcode == 0) launch_spmv<double, double>(bands, x, y, n_pad, h, o, s);
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
