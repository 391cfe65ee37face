// Fused vector steps for Hopper (sm_90a): K4 of the port (MINRES's Lanczos
// step), CG's two update kernels U and P (cg_update_kernel,
// cg_direction_kernel) and CS-MINRES's two, A and B (csm_lanczos_kernel,
// csm_update_kernel), each pair described before it below.
//
// Layout as in dia_spmv.cu: vectors are flat, h zeros | n_pad body entries |
// h zeros, with n_pad a multiple of ROW_TILE and every body 16-byte aligned.
//
// K4  orth_norm_kernel replaces _orth_norm_kernel
//     (sprsolve_tpu/ops/pallas_fused.py:37, wrapper fused_orth_norm_call :58):
//     out = a - beta * v_old - alpha * v over the body entries, both halos of
//     out zero, and s = sum out*out over the body entries -- MINRES's
//     orthogonalisation and the norm of the next Lanczos vector in one pass.
//
// What bounds it on an H100: HBM bytes.  It streams 3 reads and 1 write per
// entry at 5 flops: a pure streaming pass, 16 MB at the 100^3 Poisson in
// f32, so a launch and a block's round trip weigh as much as the bytes.
// The design is dia_spmv.cu's K2/K3 template without the SpMV:
//  * One launch, deterministic.  A block sums each tile's squares in a
//    fixed tree (block_sum) and writes one partial per tile to the scratch
//    the K2/K3 wrappers keep per (device, stream); then __threadfence and an
//    integer atomicAdd on the ticket at its head tell the last block to
//    finish.  That block sums the partials in tile order (thread t takes
//    tiles t, t + K4_THREADS, ..., TAIL_LOADS loads in flight, then
//    block_sum), writes s and resets the ticket to 0 -- the kernel replays
//    inside a CUDA graph.  No float atomics: s depends on n_pad alone, not
//    on the grid, and the wrapper calls nothing after the launch.
//  * 16-byte loads, 4 rows a thread.  A thread owns 4 consecutive rows of a
//    K4_TILE-row tile: one float4 of each of a, v_old and v (two double2 in
//    f64) and one such store.  The last tile may be ragged (n_pad is a
//    multiple of 256 only): a quad past the body is not read.
//  * One wave.  The caller launches min(tiles, blocks_per_sm * SMs) blocks
//    (8 an SM in f32, 4 in f64, as K2/K3) and each walks tiles blockIdx.x,
//    + gridDim.x, ...; the warps' sums of consecutive tiles alternate
//    between two shared arrays, so a warp may start the next tile while the
//    first warp still reads this one's.
//  * No barrier before the first load.  Every thread reads beta and alpha
//    itself through the read-only path; the halos are cleared after the
//    tiles, by a grid-stride walk, for any h <= n_pad.
//  * v+ rounds as the first K4 did: t = fma(-beta, v_old, a), then
//    fma(-alpha, v, t), spelled out, the contraction nvcc gave the first
//    K4's a[k] - beta * v_old[k] - alpha * v[k].
// Tried on an H100 80GB HBM3 at 700 W and not kept, for no steady gain
// (PERF.md, section 6):
// a and v_old loaded with the streaming hint (evict first; 0.2-0.4 us
// faster cold in f32, 2-3 us slower warm in f64 at 1M rows); the ticket
// taken by one release-acquire atomic in place of the fence and a relaxed
// atomicAdd; half the wave of blocks, each walking two tiles or more.  What
// separates K4 from a plain elementwise pass of its bytes (torch.addcmul,
// about 2 us faster) is the tail: the last block's fence, ticket and read
// of the partials.
// The launcher allocates nothing and never synchronises; it launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define ROW_TILE 256                  // as in dia_spmv.cu and ops/padded_dia.py
#define K4_THREADS 256                // threads of a block
#define K4_TILE (4 * K4_THREADS)      // rows of a tile, 4 per thread (DOT_TILE)
#define SCRATCH_HEAD 256              // scratch bytes before the partials
                                      // (as in dia_spmv.cu: one ticket)
#define TAIL_LOADS 8                  // partials a thread of the last block
                                      // loads at once: at 977 tiles, 0.5-0.8
                                      // us faster warm than K2/K3's loop of
                                      // one load a step (H100 80GB HBM3,
                                      // 700 W; PERF.md, section 6)

// blocks that share an SM: 8 (all its 2048 threads) in f32, 4 in f64
template <typename V>
__host__ __device__ constexpr int blocks_per_sm() { return sizeof(V) == 4 ? 8 : 4; }

namespace {

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// dia_spmv.cu's block_sum: the block's sum in thread 0, in a fixed tree
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = V(0);
  if (warp == 0) {
    v = lane < K4_THREADS / 32 ? smem[lane] : V(0);
    v = warp_sum(v);
  }
  return v;
}

__device__ __forceinline__ float fmadd(float b, float x, float acc) { return __fmaf_rn(b, x, acc); }
__device__ __forceinline__ double fmadd(double b, double x, double acc) { return __fma_rn(b, x, acc); }

template <typename V>
struct Quad {
  V v[4];
};

// p[0..3], p 16-byte aligned, through the read-only path
__device__ __forceinline__ Quad<float> ld_quad(const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ Quad<double> ld_quad(const double* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = __ldg(q), b = __ldg(q + 1);
  return {{a.x, a.y, b.x, b.y}};
}

__device__ __forceinline__ void st_quad(float* p, const Quad<float>& q) {
  *reinterpret_cast<float4*>(p) = make_float4(q.v[0], q.v[1], q.v[2], q.v[3]);
}

__device__ __forceinline__ void st_quad(double* p, const Quad<double>& q) {
  reinterpret_cast<double2*>(p)[0] = make_double2(q.v[0], q.v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(q.v[2], q.v[3]);
}

// scratch: the ticket (unsigned, 0 between launches) at ticket, and one
// partial per tile at partials
template <typename V>
__global__ void __launch_bounds__(K4_THREADS, blocks_per_sm<V>())
orth_norm_kernel(const V* __restrict__ a, const V* __restrict__ vold,
                 const V* __restrict__ v, const V* __restrict__ beta,
                 const V* __restrict__ alpha, V* __restrict__ out,
                 V* __restrict__ sumsq, V* __restrict__ partials,
                 unsigned* __restrict__ ticket, long long n_pad, long long h) {
  __shared__ V s_p[2][K4_THREADS / 32];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const V nb = -__ldg(beta), na = -__ldg(alpha);
  const V* ab = a + h;
  const V* ob = vold + h;
  const V* vb = v + h;
  V* yb = out + h;
  const long long n_tiles = (n_pad + K4_TILE - 1) / K4_TILE;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long i = tile * K4_TILE + 4 * t;  // this thread's rows: i .. i + 3
    V ps = V(0);
    if (i < n_pad) {  // n_pad is a multiple of 4: the quad is whole
      const Quad<V> aq = ld_quad(ab + i);
      const Quad<V> oq = ld_quad(ob + i);
      const Quad<V> vq = ld_quad(vb + i);
      Quad<V> r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r.v[k] = fmadd(na, vq.v[k], fmadd(nb, oq.v[k], aq.v[k]));
        ps = fmadd(r.v[k], r.v[k], ps);
      }
      st_quad(yb + i, r);
    }
    ps = block_sum(ps, s_p[buf]);
    if (t == 0) partials[tile] = ps;
  }
  const long long stride = (long long)gridDim.x * K4_THREADS;
  for (long long k = (long long)blockIdx.x * K4_THREADS + t; k < h; k += stride) {
    out[k] = V(0);
    out[h + n_pad + k] = V(0);
  }
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every partial is in L2 (read past L1 with __ldcg); sum
  // them in tile order
  V q = V(0);
  for (long long k0 = t; k0 < n_tiles; k0 += TAIL_LOADS * K4_THREADS) {
    V pv[TAIL_LOADS];
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) {
      const long long k = k0 + (long long)u * K4_THREADS;
      pv[u] = k < n_tiles ? __ldcg(partials + k) : V(0);
    }
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) q = q + pv[u];
  }
  q = block_sum(q, s_p[0]);
  if (t == 0) {
    *sumsq = q;
    *ticket = 0u;
  }
}

template <typename V>
void launch_orth_norm(const void* a, const void* vold, const void* v,
                      const void* beta, const void* alpha, void* out, void* sumsq,
                      char* scratch, int grid, long long n_pad, long long h,
                      cudaStream_t s) {
  orth_norm_kernel<V><<<grid, K4_THREADS, 0, s>>>(
      (const V*)a, (const V*)vold, (const V*)v, (const V*)beta, (const V*)alpha,
      (V*)out, (V*)sumsq, (V*)(scratch + SCRATCH_HEAD), (unsigned*)scratch, n_pad, h);
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15u) != 0; }

}  // namespace

extern "C" int sprsolve_orth_norm_tile() { return K4_TILE; }

// K4 blocks that share an SM, by vector type code
extern "C" int sprsolve_orth_norm_blocks_per_sm(int vcode) {
  return vcode == 1 ? blocks_per_sm<double>() : blocks_per_sm<float>();
}

// K4.  vcode 0 = f32, 1 = f64 (vectors, beta, alpha and sumsq alike);
// sumsq: one value.  scratch: the caller's per-stream area of scratch_bytes
// >= SCRATCH_HEAD + tiles * sizeof(V) bytes, its ticket zero before the
// first launch (each launch leaves it so).  grid: at least 1 block; neither
// out nor sumsq depends on it.  a, v_old, v, out and scratch 16-byte
// aligned, as the body (h * sizeof(V) a multiple of 16).
extern "C" int sprsolve_orth_norm(int vcode, const void* a, const void* vold,
                                  const void* v, const void* beta,
                                  const void* alpha, void* out, void* sumsq,
                                  void* scratch, long long scratch_bytes, int grid,
                                  long long n_pad, long long h, void* stream) {
  const long long vbytes = vcode == 1 ? 8 : 4;
  const long long n_tiles = (n_pad + K4_TILE - 1) / K4_TILE;
  if ((vcode != 0 && vcode != 1) || n_pad <= 0 || n_pad % ROW_TILE != 0 || h < 0 ||
      h > n_pad || grid < 1 || scratch_bytes < SCRATCH_HEAD + n_tiles * vbytes)
    return (int)cudaErrorInvalidValue;
  if (misaligned(a) || misaligned(vold) || misaligned(v) || misaligned(out) ||
      misaligned(scratch) || (h * vbytes) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0)
    launch_orth_norm<float>(a, vold, v, beta, alpha, out, sumsq, (char*)scratch, grid,
                            n_pad, h, s);
  else
    launch_orth_norm<double>(a, vold, v, beta, alpha, out, sumsq, (char*)scratch, grid,
                             n_pad, h, s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// U and P: CG's vector recurrence in two passes.  They replace no TPU
// kernel: the JAX package's CG (sprsolve_tpu/solvers/cg.py) leaves these
// updates to XLA's fusion, and in eager PyTorch they were 17 launches and
// 19 vector passes an iteration.  Vectors are flat, of any length n (a
// padded layout's halos are entries like any other); d is the Jacobi
// diagonal's reciprocal, or absent (M = I, no d stream).
//
// U  cg_update_kernel: alpha = rz / (pq > 0 ? pq : 1), read from device
//    pointers; x' = x + alpha*p (the solver passes a buffer other than x, so
//    a breakdown keeps x); r' = r - alpha*q; and in the same pass
//    rz' = sum r'*(d*r') and rr' = sum r'^2 (rz' = rr' without d), z = d*r'
//    never stored.  The last block writes
//    stats = [rz', rr', sqrt(rr'), ok, sqrt(rr') > tol, sqrt(rr') <= tol],
//    the predicates as 1 or 0: the one tensor the solver reads on the host.
// P  cg_direction_kernel: p' = d*r' + beta*p, beta = rz' / rz read from
//    device pointers.  beta needs U's global sum, so P cannot join U's pass.
//
// What bounds them on an H100: HBM bytes.  In f32 with d, U reads 5 and
// writes 2 values a row (28 bytes), P reads 3 and writes 1 (16 bytes), at a
// few flops a row: at 256^3 rows 0.47 and 0.27 GB, 140 and 80 us at
// 3.35 TB/s, where the eager ops moved 1.27 GB.  The design is K4's:
//  * One wave of blocks, each walking tiles of CG_TILE rows blockIdx.x,
//    + gridDim.x, ...: 4 U blocks an SM in f32 and f64, 8 P blocks in f32
//    and 4 in f64.  U at 8 blocks an SM (32 registers a thread) spilled and
//    ran at 0.70 of its bound at 256^3 in f32; at 4, 5, 6 and 8 blocks it
//    took 173, 173, 176 and 203 us (H100 80GB HBM3, 700 W; PERF.md,
//    section 6).
//  * 16-byte loads, 4 rows a thread, when every vector starts 16-byte
//    aligned (VEC); otherwise, and in a ragged last quad, one row at a time
//    with the same arithmetic, so no bit depends on alignment.
//  * U's sums as K4's sum: each tile's two sums in a fixed tree (one
//    barrier for both), one partial each per tile in the per-stream scratch,
//    then __threadfence and the ticket; the last block sums the partials in
//    tile order and resets the ticket.  rz' and rr' depend on n alone, not
//    on the grid, and accumulate in the vectors' dtype.
// r and x (U) and p (P) may be their own outputs: they are read through the
// coherent path, each entry by the thread that writes it, before it does.

#define CG_THREADS 256                // threads of a block
#define CG_TILE (4 * CG_THREADS)      // rows of a tile, 4 per thread (DOT_TILE)

// blocks that share an SM: U's 55-64 registers a thread allow 1024 threads;
// P's 28-40 allow all 2048 in f32
template <typename V>
__host__ __device__ constexpr int cg_update_blocks_per_sm() { return 4; }
template <typename V>
__host__ __device__ constexpr int cg_direction_blocks_per_sm() { return sizeof(V) == 4 ? 8 : 4; }

namespace {

// p[0..3] through the coherent path: a vector the kernel may also write
__device__ __forceinline__ Quad<float> ld_quad_rw(const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ Quad<double> ld_quad_rw(const double* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = q[0], b = q[1];
  return {{a.x, a.y, b.x, b.y}};
}

__device__ __forceinline__ float sqrt_rn(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return __dsqrt_rn(v); }

// block_sum of a and of b, both in thread 0, behind one barrier
template <typename V>
__device__ __forceinline__ void block_sum2(V& a, V& b, V (*smem)[CG_THREADS / 32]) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    smem[0][warp] = a;
    smem[1][warp] = b;
  }
  __syncthreads();
  a = b = V(0);
  if (warp == 0) {
    a = warp_sum(lane < CG_THREADS / 32 ? smem[0][lane] : V(0));
    b = warp_sum(lane < CG_THREADS / 32 ? smem[1][lane] : V(0));
  }
}

// one row of U: x', r', and its terms of rz' and rr'
template <typename V, bool HAS_D>
__device__ __forceinline__ void cg_row(V x, V p, V r, V q, V d, V alpha, V& xn, V& rn,
                                       V& rz, V& rr) {
  xn = fmadd(alpha, p, x);
  rn = fmadd(-alpha, q, r);
  rr = fmadd(rn, rn, rr);
  if (HAS_D) rz = fmadd(rn, d * rn, rz);
}

// scratch: the ticket (unsigned, 0 between launches) at ticket, then the
// tiles' partials of rr' and, with d, of rz'
template <typename V, bool HAS_D, bool VEC>
__global__ void __launch_bounds__(CG_THREADS, cg_update_blocks_per_sm<V>())
cg_update_kernel(const V* x, const V* __restrict__ p, const V* r, const V* __restrict__ q,
                 const V* __restrict__ d, const V* __restrict__ rz,
                 const V* __restrict__ pq, const V* __restrict__ tol, V* xo, V* ro,
                 V* __restrict__ stats, V* __restrict__ partials,
                 unsigned* __restrict__ ticket, long long n) {
  __shared__ V s_p[2][2][CG_THREADS / 32];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const V pqv = __ldg(pq);
  const bool ok = pqv > V(0);
  const V alpha = __ldg(rz) / (ok ? pqv : V(1));
  const long long n_tiles = (n + CG_TILE - 1) / CG_TILE;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long i = tile * CG_TILE + 4 * t;  // this thread's rows: i .. i + 3
    V srz = V(0), srr = V(0);
    if (VEC && i + 4 <= n) {
      const Quad<V> xq = ld_quad_rw(x + i), rq = ld_quad_rw(r + i);
      const Quad<V> pv = ld_quad(p + i), qv = ld_quad(q + i);
      Quad<V> dq = {};
      if (HAS_D) dq = ld_quad(d + i);
      Quad<V> xn, rn;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cg_row<V, HAS_D>(xq.v[k], pv.v[k], rq.v[k], qv.v[k], dq.v[k], alpha, xn.v[k],
                         rn.v[k], srz, srr);
      st_quad(xo + i, xn);
      st_quad(ro + i, rn);
    } else {
      for (long long k = i; k < i + 4 && k < n; ++k) {
        V xn, rn;
        cg_row<V, HAS_D>(x[k], __ldg(p + k), r[k], __ldg(q + k),
                         HAS_D ? __ldg(d + k) : V(0), alpha, xn, rn, srz, srr);
        xo[k] = xn;
        ro[k] = rn;
      }
    }
    block_sum2(srr, srz, s_p[buf]);
    if (t == 0) {
      partials[tile] = srr;
      if (HAS_D) partials[n_tiles + tile] = srz;
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
  V a = V(0), b = V(0);
  for (long long k0 = t; k0 < n_tiles; k0 += TAIL_LOADS * CG_THREADS) {
    V pa[TAIL_LOADS], pb[TAIL_LOADS];
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) {
      const long long k = k0 + (long long)u * CG_THREADS;
      pa[u] = k < n_tiles ? __ldcg(partials + k) : V(0);
      pb[u] = HAS_D && k < n_tiles ? __ldcg(partials + n_tiles + k) : V(0);
    }
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) {
      a = a + pa[u];
      b = b + pb[u];
    }
  }
  block_sum2(a, b, s_p[0]);
  if (t == 0) {
    const V nrm = sqrt_rn(a), tl = __ldg(tol);
    stats[0] = HAS_D ? b : a;
    stats[1] = a;
    stats[2] = nrm;
    stats[3] = ok ? V(1) : V(0);
    stats[4] = nrm > tl ? V(1) : V(0);
    stats[5] = nrm <= tl ? V(1) : V(0);
    *ticket = 0u;
  }
}

template <typename V, bool HAS_D, bool VEC>
__global__ void __launch_bounds__(CG_THREADS, cg_direction_blocks_per_sm<V>())
cg_direction_kernel(const V* __restrict__ r, const V* __restrict__ d, const V* p,
                    const V* __restrict__ rzn, const V* __restrict__ rz, V* po,
                    long long n) {
  const V beta = __ldg(rzn) / __ldg(rz);
  const long long n_tiles = (n + CG_TILE - 1) / CG_TILE;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long i = tile * CG_TILE + 4 * threadIdx.x;
    if (VEC && i + 4 <= n) {
      const Quad<V> rq = ld_quad(r + i), pv = ld_quad_rw(p + i);
      Quad<V> dq = {};
      if (HAS_D) dq = ld_quad(d + i);
      Quad<V> o;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o.v[k] = fmadd(beta, pv.v[k], HAS_D ? dq.v[k] * rq.v[k] : rq.v[k]);
      st_quad(po + i, o);
    } else {
      for (long long k = i; k < i + 4 && k < n; ++k)
        po[k] = fmadd(beta, p[k], HAS_D ? __ldg(d + k) * __ldg(r + k) : __ldg(r + k));
    }
  }
}

template <typename V>
void launch_cg_update(bool has_d, bool vec, int grid, cudaStream_t s, const void* x,
                      const void* p, const void* r, const void* q, const void* d,
                      const void* rz, const void* pq, const void* tol, void* xo, void* ro,
                      void* stats, char* scratch, long long n) {
  auto kernel = has_d ? (vec ? cg_update_kernel<V, true, true> : cg_update_kernel<V, true, false>)
                      : (vec ? cg_update_kernel<V, false, true> : cg_update_kernel<V, false, false>);
  kernel<<<grid, CG_THREADS, 0, s>>>(
      (const V*)x, (const V*)p, (const V*)r, (const V*)q, (const V*)d, (const V*)rz,
      (const V*)pq, (const V*)tol, (V*)xo, (V*)ro, (V*)stats,
      (V*)(scratch + SCRATCH_HEAD), (unsigned*)scratch, n);
}

template <typename V>
void launch_cg_direction(bool has_d, bool vec, int grid, cudaStream_t s, const void* r,
                         const void* d, const void* p, const void* rzn, const void* rz,
                         void* po, long long n) {
  auto kernel = has_d ? (vec ? cg_direction_kernel<V, true, true>
                             : cg_direction_kernel<V, true, false>)
                      : (vec ? cg_direction_kernel<V, false, true>
                             : cg_direction_kernel<V, false, false>);
  kernel<<<grid, CG_THREADS, 0, s>>>((const V*)r, (const V*)d, (const V*)p, (const V*)rzn,
                                     (const V*)rz, (V*)po, n);
}

}  // namespace

extern "C" int sprsolve_cg_tile() { return CG_TILE; }

// U blocks and P blocks that share an SM, by vector type code
extern "C" int sprsolve_cg_update_blocks_per_sm(int vcode) {
  return vcode == 1 ? cg_update_blocks_per_sm<double>() : cg_update_blocks_per_sm<float>();
}

extern "C" int sprsolve_cg_direction_blocks_per_sm(int vcode) {
  return vcode == 1 ? cg_direction_blocks_per_sm<double>()
                    : cg_direction_blocks_per_sm<float>();
}

// U.  vcode 0 = f32, 1 = f64 (vectors, rz, pq, tol and stats alike); d null
// for M = I; stats: 6 values.  xo may be x and ro may be r; no other
// vector may overlap another.  scratch: the caller's per-stream area of
// scratch_bytes >= SCRATCH_HEAD + 2 * tiles * sizeof(V) bytes, 16-byte
// aligned, its ticket zero before the first launch (each launch leaves it
// so).  grid: at least 1 block; no output depends on it.  Vectors of any
// alignment: 16-byte loads where all are 16-byte aligned.
extern "C" int sprsolve_cg_update(int vcode, const void* x, const void* p, const void* r,
                                  const void* q, const void* d, const void* rz,
                                  const void* pq, const void* tol, void* xo, void* ro,
                                  void* stats, void* scratch, long long scratch_bytes,
                                  int grid, long long n, void* stream) {
  const long long vbytes = vcode == 1 ? 8 : 4;
  const long long n_tiles = (n + CG_TILE - 1) / CG_TILE;
  if ((vcode != 0 && vcode != 1) || n <= 0 || grid < 1 ||
      scratch_bytes < SCRATCH_HEAD + 2 * n_tiles * vbytes)
    return (int)cudaErrorInvalidValue;
  if (misaligned(scratch)) return (int)cudaErrorMisalignedAddress;
  const bool vec = !(misaligned(x) || misaligned(p) || misaligned(r) || misaligned(q) ||
                     (d && misaligned(d)) || misaligned(xo) || misaligned(ro));
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0)
    launch_cg_update<float>(d != nullptr, vec, grid, s, x, p, r, q, d, rz, pq, tol, xo, ro,
                            stats, (char*)scratch, n);
  else
    launch_cg_update<double>(d != nullptr, vec, grid, s, x, p, r, q, d, rz, pq, tol, xo, ro,
                             stats, (char*)scratch, n);
  return (int)cudaGetLastError();
}

// P.  vcode as for U (vectors, rzn and rz alike); d null for M = I; po may be
// p.  grid: at least 1 block.
extern "C" int sprsolve_cg_direction(int vcode, const void* r, const void* d,
                                     const void* p, const void* rzn, const void* rz,
                                     void* po, int grid, long long n, void* stream) {
  if ((vcode != 0 && vcode != 1) || n <= 0 || grid < 1) return (int)cudaErrorInvalidValue;
  const bool vec = !(misaligned(r) || (d && misaligned(d)) || misaligned(p) || misaligned(po));
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0)
    launch_cg_direction<float>(d != nullptr, vec, grid, s, r, d, p, rzn, rz, po, n);
  else
    launch_cg_direction<double>(d != nullptr, vec, grid, s, r, d, p, rzn, rz, po, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// A and B: CS-MINRES's vector recurrence in two passes, for a real M^-1 =
// diag(d) or none.  They replace no TPU kernel: the JAX package's CS-MINRES
// (sprsolve_tpu/solvers/cs_minres.py) leaves these updates to XLA's fusion,
// and in eager PyTorch they were about 60 launches and 30 passes over the
// complex vectors an iteration.  Vectors are flat and complex (c64 as float
// pairs, c128 as double pairs), of any length n in complex rows; d is real,
// of the vectors' real type, or absent (M = I: w is v, no w stream).
//
// A  csm_lanczos_kernel, after K6 gave y = A conj(w) and alpha:
//    v' = y - beta v_old - alpha v, written over v_old; w' = d v' (never
//    stored without d); and in the same pass the dot b2 = sum conj(v') w'
//    (real and imaginary parts), or sum |v'|^2 without d.  Its last block
//    runs the Givens step of the iteration on the scalars in the state
//    (the CSM_* slots, one real array): the beta^2 gate, beta' = sqrt(b2),
//    ts = 1/beta', r2, r3, r1_inv, c', s', the residual and its test; it
//    leaves B's coefficients and [converged, bad] there and moves the
//    rotation on.  Only that block writes the state; every block reads
//    beta before it takes the ticket, so none reads it after.
// B  csm_update_kernel, after the host read and only when the gate passed:
//    p' = r1_inv (conj(w) - r2 p - r3 p_old), written over p_old;
//    x += xc p' (xc = c' eta beta_1); v' and w' scaled by ts, all in place.
//
// What bounds them on an H100: HBM bytes.  In c64 with d, A reads 3 complex
// and 1 real value a row and writes 2 complex (44 bytes), B reads 6 and
// writes 4 (80 bytes): at 256^3 rows 0.74 and 1.34 GB, 0.22 and 0.40 ms at
// 3.35 TB/s, where the eager ops moved about 4 GB.  The design is U's:
//  * One wave of blocks, each walking tiles of CSM_TILE complex rows
//    blockIdx.x, + gridDim.x, ... (CDOT_TILE, so the dot kernels' scratch
//    and grid rule serve them).
//  * 16-byte loads of two c64 rows (two loads of one c128 row each) a
//    thread, when every vector starts 16-byte aligned and d 8- (f32) or
//    16-byte (f64) aligned (VEC); otherwise, and in a ragged last pair, one
//    row at a time with the same arithmetic, so no bit depends on alignment.
//  * A's sums as U's: each tile's two sums in a fixed tree, one partial each
//    per tile, the ticket, the last block sums the partials in tile order,
//    so b2 depends on n alone, not on the grid.
// v_old (A) and p_old, x, v', w' (B) are read through the coherent path,
// each entry by the thread that writes it, before it does.

#define CSM_THREADS 256                // threads of a block
#define CSM_TILE (2 * CSM_THREADS)     // complex rows of a tile, 2 a thread
// the state's slots (ops/fused.py CSM_*): a complex value takes two, its
// real part first
#define CSM_BETA 0
#define CSM_C_OLD 1
#define CSM_C 3
#define CSM_S_OLD 5
#define CSM_S 6
#define CSM_ETA 7
#define CSM_RES 9
#define CSM_THRESHOLD 10
#define CSM_BETA_ONE 11
#define CSM_R2 12
#define CSM_R3 14
#define CSM_R1_INV 15
#define CSM_TS 16
#define CSM_XC 17
#define CSM_FLAGS 19
#define CSM_SLOTS 21

static_assert(CSM_THREADS == CG_THREADS, "A shares U's block_sum2");

// blocks that share an SM: A's and B's c64 bodies fit 64 registers a
// thread; B's c128 body holds six double pairs
template <typename R>
__host__ __device__ constexpr int csm_lanczos_blocks_per_sm() { return 4; }
template <typename R>
__host__ __device__ constexpr int csm_update_blocks_per_sm() { return sizeof(R) == 4 ? 4 : 3; }

namespace {

template <typename R>
__device__ __forceinline__ R machine_eps() {
  return sizeof(R) == 4 ? R(1.1920928955078125e-07) : R(2.220446049250313e-16);
}

// d[0..1]: 8 bytes (f32, 8-byte aligned) or 16 (f64) through the read-only path
__device__ __forceinline__ void ld_two(const float* p, float& a, float& b) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  a = t.x;
  b = t.y;
}

__device__ __forceinline__ void ld_two(const double* p, double& a, double& b) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  a = t.x;
  b = t.y;
}

// one complex row of A: v' = y - beta v_old - alpha v (nb = -beta), w' = d v',
// and its terms of sum conj(v') w' (or of sum |v'|^2 without d)
template <typename R, bool HAS_D>
__device__ __forceinline__ void csm_lanczos_row(R yr, R yi, R orr, R oi, R vr, R vi, R d,
                                                R nb, R ar, R ai, R& nr, R& ni, R& wr,
                                                R& wi, R& sre, R& sim) {
  const R tr = fmadd(nb, orr, yr), ti = fmadd(nb, oi, yi);
  nr = fmadd(-ar, vr, fmadd(ai, vi, tr));
  ni = fmadd(-ar, vi, fmadd(-ai, vr, ti));
  if (HAS_D) {
    wr = nr * d;
    wi = ni * d;
    sre = fmadd(nr, wr, fmadd(ni, wi, sre));
    sim = sim + fmadd(nr, wi, -(ni * wr));
  } else {
    sre = fmadd(nr, nr, fmadd(ni, ni, sre));
  }
}

// the Givens step of one iteration (cs_minres.py's csm_givens and the gate)
// from b2 = (re, im) and alpha, in the state st: one thread
template <typename R, bool HAS_D>
__device__ void csm_givens_step(R* st, R re, R im, R ar, R ai) {
  const R eps = machine_eps<R>();
  const R beta = st[CSM_BETA];
  R beta_n;
  bool bad = false;
  if (HAS_D) {
    // beta^2 must be real positive above the dot's noise floor eps beta_old^2
    const R noise = beta * beta;
    const R big = (isnan(re) || fabs(re) >= noise) ? fabs(re) : noise;
    bad = re < -eps * noise || fabs(im) > eps * big;
    beta_n = sqrt_rn(re < R(0) ? R(0) : re);
  } else {
    beta_n = sqrt_rn(re);
  }
  const R ts = beta_n > R(0) ? R(1) / beta_n : R(0);
  const R cor = st[CSM_C_OLD], coi = st[CSM_C_OLD + 1];
  const R cr = st[CSM_C], ci = st[CSM_C + 1];
  const R s_old = st[CSM_S_OLD], s = st[CSM_S];
  const R r3 = s_old * beta;
  const R trr = cor * beta, tri = -coi * beta;                 // conj(c_old) beta
  const R r2r = ar * s + (cr * trr - ci * tri);                // alpha s + c tr
  const R r2i = ai * s + (cr * tri + ci * trr);
  const R r1r = (cr * ar + ci * ai) - trr * s;                 // conj(c) alpha - tr s
  const R r1i = (cr * ai - ci * ar) - tri * s;
  const R r1_inv = R(1) / sqrt_rn(r1r * r1r + r1i * r1i + beta_n * beta_n);
  const R cnr = r1r * r1_inv, cni = -r1i * r1_inv;             // conj(r1_hat) r1_inv
  const R s_n = beta_n * r1_inv;
  const R res_n = st[CSM_RES] * fabs(s_n);
  const R er = st[CSM_ETA], ei = st[CSM_ETA + 1], b1 = st[CSM_BETA_ONE];
  st[CSM_XC] = (cnr * er - cni * ei) * b1;                     // c' eta beta_1
  st[CSM_XC + 1] = (cnr * ei + cni * er) * b1;
  st[CSM_R2] = r2r;
  st[CSM_R2 + 1] = r2i;
  st[CSM_R3] = r3;
  st[CSM_R1_INV] = r1_inv;
  st[CSM_TS] = ts;
  st[CSM_FLAGS] = res_n < st[CSM_THRESHOLD] ? R(1) : R(0);
  st[CSM_FLAGS + 1] = bad ? R(1) : R(0);
  st[CSM_BETA] = beta_n;
  st[CSM_C_OLD] = cr;
  st[CSM_C_OLD + 1] = ci;
  st[CSM_C] = cnr;
  st[CSM_C + 1] = cni;
  st[CSM_S_OLD] = s;
  st[CSM_S] = s_n;
  st[CSM_ETA] = er * -s_n;
  st[CSM_ETA + 1] = ei * -s_n;
  st[CSM_RES] = res_n;
}

// y, v_old (v' out), v, w' out: 2n reals each; d: n reals or null.  scratch:
// the ticket at ticket, then the tiles' partials of Re b2 and, with d, Im b2
template <typename R, bool HAS_D, bool VEC>
__global__ void __launch_bounds__(CSM_THREADS, csm_lanczos_blocks_per_sm<R>())
csm_lanczos_kernel(const R* __restrict__ y, R* __restrict__ vold, const R* __restrict__ v,
                   const R* __restrict__ d, const R* __restrict__ alpha, R* st,
                   R* __restrict__ wout, R* __restrict__ partials,
                   unsigned* __restrict__ ticket, long long n) {
  __shared__ R s_p[2][2][CSM_THREADS / 32];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const R nb = -st[CSM_BETA], ar = __ldg(alpha), ai = __ldg(alpha + 1);
  const long long n_tiles = (n + CSM_TILE - 1) / CSM_TILE;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long i = tile * CSM_TILE + 2 * t;  // this thread's rows: i, i + 1
    R sre = R(0), sim = R(0);
    if (VEC && i + 2 <= n) {
      const Quad<R> yq = ld_quad(y + 2 * i), oq = ld_quad_rw(vold + 2 * i);
      const Quad<R> vq = ld_quad(v + 2 * i);
      R d0 = R(0), d1 = R(0);
      if (HAS_D) ld_two(d + i, d0, d1);
      Quad<R> nq, wq;
      csm_lanczos_row<R, HAS_D>(yq.v[0], yq.v[1], oq.v[0], oq.v[1], vq.v[0], vq.v[1], d0, nb,
                                ar, ai, nq.v[0], nq.v[1], wq.v[0], wq.v[1], sre, sim);
      csm_lanczos_row<R, HAS_D>(yq.v[2], yq.v[3], oq.v[2], oq.v[3], vq.v[2], vq.v[3], d1, nb,
                                ar, ai, nq.v[2], nq.v[3], wq.v[2], wq.v[3], sre, sim);
      st_quad(vold + 2 * i, nq);
      if (HAS_D) st_quad(wout + 2 * i, wq);
    } else {
      for (long long k = i; k < i + 2 && k < n; ++k) {
        R nr, ni, wr, wi;
        csm_lanczos_row<R, HAS_D>(__ldg(y + 2 * k), __ldg(y + 2 * k + 1), vold[2 * k],
                                  vold[2 * k + 1], __ldg(v + 2 * k), __ldg(v + 2 * k + 1),
                                  HAS_D ? __ldg(d + k) : R(0), nb, ar, ai, nr, ni, wr, wi,
                                  sre, sim);
        vold[2 * k] = nr;
        vold[2 * k + 1] = ni;
        if (HAS_D) {
          wout[2 * k] = wr;
          wout[2 * k + 1] = wi;
        }
      }
    }
    block_sum2(sre, sim, s_p[buf]);
    if (t == 0) {
      partials[tile] = sre;
      if (HAS_D) partials[n_tiles + tile] = sim;
    }
  }
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every partial is in L2 (read past L1 with __ldcg); sum
  // them in tile order, then the Givens step
  R a = R(0), b = R(0);
  for (long long k0 = t; k0 < n_tiles; k0 += TAIL_LOADS * CSM_THREADS) {
    R pa[TAIL_LOADS], pb[TAIL_LOADS];
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) {
      const long long k = k0 + (long long)u * CSM_THREADS;
      pa[u] = k < n_tiles ? __ldcg(partials + k) : R(0);
      pb[u] = HAS_D && k < n_tiles ? __ldcg(partials + n_tiles + k) : R(0);
    }
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) {
      a = a + pa[u];
      b = b + pb[u];
    }
  }
  block_sum2(a, b, s_p[0]);
  if (t == 0) {
    csm_givens_step<R, HAS_D>(st, a, b, ar, ai);
    *ticket = 0u;
  }
}

// one complex row of B: p' = r1_inv (conj(w) - r2 p - r3 p_old), x += xc p'
template <typename R>
__device__ __forceinline__ void csm_update_row(R wr, R wi, R pr, R pi, R& por, R& poi, R& xr,
                                               R& xi, R r2r, R r2i, R r3, R r1_inv, R xcr,
                                               R xci) {
  const R tr = fmadd(-r3, por, fmadd(-r2r, pr, fmadd(r2i, pi, wr)));
  const R ti = fmadd(-r3, poi, fmadd(-r2r, pi, fmadd(-r2i, pr, -wi)));
  por = r1_inv * tr;
  poi = r1_inv * ti;
  xr = fmadd(xcr, por, fmadd(-xci, poi, xr));
  xi = fmadd(xcr, poi, fmadd(xci, por, xi));
}

// w, p, p_old (p' out), x, v', w' (null without d): 2n reals each
template <typename R, bool HAS_D, bool VEC>
__global__ void __launch_bounds__(CSM_THREADS, csm_update_blocks_per_sm<R>())
csm_update_kernel(const R* __restrict__ w, const R* __restrict__ p, R* __restrict__ pold,
                  R* __restrict__ x, R* __restrict__ vn, R* __restrict__ wn,
                  const R* __restrict__ st, long long n) {
  const R r2r = __ldg(st + CSM_R2), r2i = __ldg(st + CSM_R2 + 1), r3 = __ldg(st + CSM_R3);
  const R r1_inv = __ldg(st + CSM_R1_INV), ts = __ldg(st + CSM_TS);
  const R xcr = __ldg(st + CSM_XC), xci = __ldg(st + CSM_XC + 1);
  const long long n_tiles = (n + CSM_TILE - 1) / CSM_TILE;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long i = tile * CSM_TILE + 2 * threadIdx.x;
    if (VEC && i + 2 <= n) {
      const Quad<R> wq = ld_quad(w + 2 * i), pq = ld_quad(p + 2 * i);
      Quad<R> oq = ld_quad_rw(pold + 2 * i), xq = ld_quad_rw(x + 2 * i);
      Quad<R> vq = ld_quad_rw(vn + 2 * i), uq = {};
      if (HAS_D) uq = ld_quad_rw(wn + 2 * i);
#pragma unroll
      for (int k = 0; k < 4; k += 2)
        csm_update_row(wq.v[k], wq.v[k + 1], pq.v[k], pq.v[k + 1], oq.v[k], oq.v[k + 1],
                       xq.v[k], xq.v[k + 1], r2r, r2i, r3, r1_inv, xcr, xci);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        vq.v[k] *= ts;
        uq.v[k] *= ts;
      }
      st_quad(pold + 2 * i, oq);
      st_quad(x + 2 * i, xq);
      st_quad(vn + 2 * i, vq);
      if (HAS_D) st_quad(wn + 2 * i, uq);
    } else {
      for (long long k = i; k < i + 2 && k < n; ++k) {
        R por = pold[2 * k], poi = pold[2 * k + 1], xr = x[2 * k], xi = x[2 * k + 1];
        csm_update_row(__ldg(w + 2 * k), __ldg(w + 2 * k + 1), __ldg(p + 2 * k),
                       __ldg(p + 2 * k + 1), por, poi, xr, xi, r2r, r2i, r3, r1_inv, xcr, xci);
        pold[2 * k] = por;
        pold[2 * k + 1] = poi;
        x[2 * k] = xr;
        x[2 * k + 1] = xi;
        vn[2 * k] *= ts;
        vn[2 * k + 1] *= ts;
        if (HAS_D) {
          wn[2 * k] *= ts;
          wn[2 * k + 1] *= ts;
        }
      }
    }
  }
}

template <typename R>
void launch_csm_lanczos(bool has_d, bool vec, int grid, cudaStream_t s, const void* y,
                        void* vold, const void* v, const void* d, const void* alpha,
                        void* st, void* wout, char* scratch, long long n) {
  auto kernel = has_d ? (vec ? csm_lanczos_kernel<R, true, true>
                             : csm_lanczos_kernel<R, true, false>)
                      : (vec ? csm_lanczos_kernel<R, false, true>
                             : csm_lanczos_kernel<R, false, false>);
  kernel<<<grid, CSM_THREADS, 0, s>>>(
      (const R*)y, (R*)vold, (const R*)v, (const R*)d, (const R*)alpha, (R*)st, (R*)wout,
      (R*)(scratch + SCRATCH_HEAD), (unsigned*)scratch, n);
}

template <typename R>
void launch_csm_update(bool has_d, bool vec, int grid, cudaStream_t s, const void* w,
                       const void* p, void* pold, void* x, void* vn, void* wn,
                       const void* st, long long n) {
  auto kernel = has_d ? (vec ? csm_update_kernel<R, true, true>
                             : csm_update_kernel<R, true, false>)
                      : (vec ? csm_update_kernel<R, false, true>
                             : csm_update_kernel<R, false, false>);
  kernel<<<grid, CSM_THREADS, 0, s>>>((const R*)w, (const R*)p, (R*)pold, (R*)x, (R*)vn,
                                      (R*)wn, (const R*)st, n);
}

bool misaligned8(const void* p) { return ((uintptr_t)p & 7u) != 0; }

}  // namespace

extern "C" int sprsolve_csm_tile() { return CSM_TILE; }
extern "C" int sprsolve_csm_slots() { return CSM_SLOTS; }

// A blocks and B blocks that share an SM, by vector type code
extern "C" int sprsolve_csm_lanczos_blocks_per_sm(int vcode) {
  return vcode == 1 ? csm_lanczos_blocks_per_sm<double>() : csm_lanczos_blocks_per_sm<float>();
}

extern "C" int sprsolve_csm_update_blocks_per_sm(int vcode) {
  return vcode == 1 ? csm_update_blocks_per_sm<double>() : csm_update_blocks_per_sm<float>();
}

// A.  vcode 0 = c64 (f32 d, alpha as two floats, state of floats), 1 =
// c128 (f64 alike); d and wout null for M = I; y, v_old, v, wout of n
// complex rows, d of n reals; v_old becomes v'.  No vector may overlap
// another.  state: CSM_SLOTS values.  scratch: the caller's per-stream area
// of scratch_bytes >= SCRATCH_HEAD + 2 * tiles * sizeof(R) bytes, 16-byte
// aligned, its ticket zero before the first launch (each launch leaves it
// so).  grid: at least 1 block; no output depends on it.
extern "C" int sprsolve_csm_lanczos(int vcode, const void* y, void* vold, const void* v,
                                    const void* d, const void* alpha, void* state, void* wout,
                                    void* scratch, long long scratch_bytes, int grid,
                                    long long n, void* stream) {
  const long long rbytes = vcode == 1 ? 8 : 4;
  const long long n_tiles = (n + CSM_TILE - 1) / CSM_TILE;
  if ((vcode != 0 && vcode != 1) || n <= 0 || grid < 1 || (d == nullptr) != (wout == nullptr) ||
      scratch_bytes < SCRATCH_HEAD + 2 * n_tiles * rbytes)
    return (int)cudaErrorInvalidValue;
  if (misaligned(scratch)) return (int)cudaErrorMisalignedAddress;
  const bool vec = !(misaligned(y) || misaligned(vold) || misaligned(v) ||
                     (wout && misaligned(wout)) ||
                     (d && (vcode == 1 ? misaligned(d) : misaligned8(d))));
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0)
    launch_csm_lanczos<float>(d != nullptr, vec, grid, s, y, vold, v, d, alpha, state, wout,
                              (char*)scratch, n);
  else
    launch_csm_lanczos<double>(d != nullptr, vec, grid, s, y, vold, v, d, alpha, state, wout,
                               (char*)scratch, n);
  return (int)cudaGetLastError();
}

// B.  vcode as for A; wn null for M = I (then w is the current v); w, p,
// p_old, x, vn, wn of n complex rows, none overlapping another; p_old
// becomes p'.  grid: at least 1 block.
extern "C" int sprsolve_csm_update(int vcode, const void* w, const void* p, void* pold,
                                   void* x, void* vn, void* wn, const void* state, int grid,
                                   long long n, void* stream) {
  if ((vcode != 0 && vcode != 1) || n <= 0 || grid < 1) return (int)cudaErrorInvalidValue;
  const bool vec = !(misaligned(w) || misaligned(p) || misaligned(pold) || misaligned(x) ||
                     misaligned(vn) || (wn && misaligned(wn)));
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0)
    launch_csm_update<float>(wn != nullptr, vec, grid, s, w, p, pold, x, vn, wn, state, n);
  else
    launch_csm_update<double>(wn != nullptr, vec, grid, s, w, p, pold, x, vn, wn, state, n);
  return (int)cudaGetLastError();
}
