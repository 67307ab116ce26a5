// Fused GroupNorm(+ReLU), forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mpi_opt_tpu/ops/pallas_gn.py:
// _fwd_kernel (launched by _forward) and _bwd_kernel (launched by
// _bwd_rule). Same contract: x is channel-last [N, S, C]; statistics
// per (sample, group) in f32 with var = E[x^2] - mean^2 clamped at 0
// (as flax's GroupNorm: rounding can make it negative at a large mean)
// and rsqrt(var + eps) inside; the backward recomputes the ReLU mask from x
// and the saved statistics (z = gamma * xhat + beta > 0) and never
// re-reads y; dgamma/dbeta leave as per-sample partials [N, C] f32 that
// the caller sums over N.
//
// What bounds it on this card: bytes. The forward must read x and write
// y, the backward read x and dy and write dx; gamma, beta, the [N, G]
// statistics and the [N, C] partials are small beside them. The TPU
// kernel meets that minimum by holding a whole sample in VMEM. Here:
//
// - A block owns one sample, a slice of CB channels holding whole
//   groups, and RB of its S rows. It stages its [RB, CB] tile of x (and
//   of dy, backward) into shared memory once, with 16-byte cp.async
//   copies issued all at once, reduces from the tile and writes y (dx)
//   from the tile: each activation crosses device memory once.
// - A slice whose S rows do not fit one block's tile (stage 0 of the
//   ResNet: 1024 rows) is split over a thread block cluster of K <= 8
//   blocks, one per RB rows. The blocks exchange their partial sums
//   through distributed shared memory (2 floats a group forward, 2 a
//   channel backward) and all sum them in rank order, so every block
//   of the cluster normalises with the same bits.
// - The plan (ops/group_norm.py::gn_plan) sizes CB and RB by bytes:
//   about 32 KB of each staged tensor a block, rows of at least 128
//   bytes, so several blocks share an SM and enough are in flight.
// - Every global access is 16 bytes (8 bf16 or 4 f32 a thread).
//   Thread t owns column j = t % V of 16-byte vectors (V = CB / VEC)
//   and rows t / V, t / V + RL, ...; it reads back from shared memory
//   only what it copied itself, so the tile needs no barrier, and a
//   warp's 32 vectors are contiguous (no bank conflicts).
// - Reductions: per-thread sums over its rows; a warp-shuffle tree
//   across lanes that share a column (V < 32); per-slot partials
//   through a small shared array (16-byte stores); then all groups of
//   the slice at once, a few lanes a group, each summing a strided
//   share of its entries, and a shuffle tree over those lanes.
// - Blocks are not persistent: a version in which each block walked
//   several slices with the next tile landing while it worked on the
//   current one was slower at every main-path shape on an H100.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 8;
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90

// z = (x - mean) * rstd * gamma + beta, rounded after every operation
// (the _rn intrinsics are never contracted into FMAs): the backward
// recomputes the same z bit for bit to decide the ReLU mask, and so do
// the plain versions in torch ops.
__device__ __forceinline__ float norm_affine(float v, float m, float rs, float ga, float be) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, m), rs), ga), be);
}

// 16 bytes <-> floats
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4], float) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4], float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8], __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Shape of one launch, shared by host and device: the plan's choices
// (cb channels and rb rows a block) and what follows from them.
struct Geom {
  int S, C, G, cb, rb;
  int vec;      // elements in 16 bytes
  int V;        // 16-byte columns of a slice row
  int rl;       // row lanes: threads that share a column
  int threads;  // threads a block
  int gs, gib;  // group size, groups in a slice
  int shfl;     // lanes of a warp that share a column are summed by shuffles
  int slots;    // rows of the per-slot partial array
  __host__ __device__ Geom(int S_, int C_, int G_, int cb_, int rb_, int elt)
      : S(S_), C(C_), G(G_), cb(cb_), rb(rb_) {
    vec = 16 / elt;
    V = cb / vec;
    rl = V > 0 && V <= kMaxThreads ? kMaxThreads / V : 1;
    threads = (V * rl + 31) / 32 * 32;
    gs = G > 0 ? C / G : 0;
    gib = gs > 0 ? cb / gs : 0;
    shfl = V > 0 && V < 32 && 32 % V == 0;
    slots = shfl ? threads / 32 : rl;
  }
};

// Shared memory of a block (k blocks a cluster): tiles, then floats.
//   forward:  tile x [rb*cb] | red [2*slots*cb] | part [k][2*gib] | stat [2*gib]
//   backward: tile x, tile dy | red [2*slots*cb] | chan [2*cb] | stat [2*gib]
// The forward's `part` holds every rank's partial sums: each block
// pushes its own into all its peers, so one cluster barrier makes them
// local. The backward's `chan` holds its own, and the peers read it
// (pushing there too held more registers live and cost occupancy).
__host__ __device__ inline size_t smem_bytes(const Geom& g, int elt, int bwd, int k) {
  const size_t tiles = (size_t)(bwd ? 2 : 1) * g.rb * g.cb * elt;
  const size_t floats = 2 * (size_t)g.slots * g.cb +
                        (bwd ? 2 * (size_t)g.cb : 2 * (size_t)k * g.gib) + 2 * (size_t)g.gib;
  return tiles + floats * sizeof(float);
}

// Per-thread sums over its rows -> red[slot][cb] (two arrays): a shuffle
// tree first where lanes of a warp share a column.
template <int VEC>
__device__ __forceinline__ void to_slots(const Geom& g, float (&a)[VEC], float (&b)[VEC],
                                         bool active, int j, float* red_a, float* red_b) {
  const int t = threadIdx.x, lane = t & 31;
  int slot = t / g.V;
  if (g.shfl) {
    for (int o = g.V; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a[e] += __shfl_xor_sync(0xffffffffu, a[e], o);
        b[e] += __shfl_xor_sync(0xffffffffu, b[e], o);
      }
    }
    active = lane < g.V;
    slot = t >> 5;
  }
  if (active) {
    float4* pa = reinterpret_cast<float4*>(red_a + slot * g.cb + j * VEC);
    float4* pb = reinterpret_cast<float4*>(red_b + slot * g.cb + j * VEC);
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      pa[h] = make_float4(a[4 * h], a[4 * h + 1], a[4 * h + 2], a[4 * h + 3]);
      pb[h] = make_float4(b[4 * h], b[4 * h + 1], b[4 * h + 2], b[4 * h + 3]);
    }
  }
}

// out[grp] = (sum over s < ns, k < gs of in[s*cb + grp*gs + k]) / div (a
// and b alike). All groups at once: L lanes a group (a power of two up
// to a warp, as many as the block has threads for), each summing a
// strided share of the group's entries, then a shuffle tree over the L.
__device__ __forceinline__ void group_reduce(const Geom& g, const float* in_a, const float* in_b,
                                             int ns, float div, float* out_a, float* out_b) {
  int L = 1;
  while (L < 32 && 2 * L * g.gib <= (int)blockDim.x) L *= 2;
  const int t = threadIdx.x, sub = t & (L - 1), per = blockDim.x / L, n = ns * g.gs;
  for (int g0 = 0; g0 < g.gib; g0 += per) {  // every thread takes the same trips
    const int grp = g0 + t / L;
    float sa = 0.f, sb = 0.f;
    if (grp < g.gib)
      for (int i = sub; i < n; i += L) {
        const int off = (i / g.gs) * g.cb + grp * g.gs + i % g.gs;
        sa += in_a[off];
        sb += in_b[off];
      }
    for (int o = L >> 1; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
    }
    if (grp < g.gib && sub == 0) {
      out_a[grp] = sa / div;
      out_b[grp] = sb / div;
    }
  }
}

// The two halves of a cluster barrier. A block may touch a peer's shared
// memory only once the peer has started: every block arrives as it
// starts and waits just before its first remote store.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A barrier over the cluster where there is one (it also orders shared
// memory across its blocks), else over the block.
__device__ __forceinline__ void cluster_or_block_sync(int k) {
  if (k > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// `p` in the shared memory of cluster rank `rank` (this block's own when
// there is no cluster)
__device__ __forceinline__ float* peer(float* p, int rank, int k) {
  return k > 1 ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

// grid = (K, C / cb, N), cluster (K, 1, 1): blockIdx.x is the block's
// rank in its cluster and picks its rows.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, Geom g, float eps, int relu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  float* red_a = reinterpret_cast<float*>(smem + (size_t)g.rb * g.cb * sizeof(T));
  float* red_b = red_a + g.slots * g.cb;
  const int k = gridDim.x, rank = blockIdx.x;
  float* part = red_b + g.slots * g.cb;  // [k][2*gib]: each rank's sum x, sum x^2
  float* stat = part + 2 * k * g.gib;    // [2*gib]: mean, rstd
  const int n = blockIdx.z, c0 = blockIdx.y * g.cb;
  const int r0 = rank * g.rb, rows = max(0, min(g.S - r0, g.rb));
  const int t = threadIdx.x, j = t % g.V;
  const bool active = t < g.V * g.rl;
  const size_t base = (size_t)n * g.S * g.C + (size_t)r0 * g.C + c0 + j * VEC;

  if (active)
    for (int r = t / g.V; r < rows; r += g.rl)
      cp_async16(tile + r * g.cb + j * VEC, x + base + (size_t)r * g.C);
  if (k > 1) cluster_arrive();
  float ga[VEC], be[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    ga[e] = gamma[c0 + j * VEC + e];
    be[e] = beta[c0 + j * VEC + e];
  }
  cp_async_wait_all();

  float s1[VEC], s2[VEC], v[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = 0.f;
  if (active)
    for (int r = t / g.V; r < rows; r += g.rl) {
      unpack(*reinterpret_cast<const uint4*>(tile + r * g.cb + j * VEC), v, T());
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s1[e] += v[e];
        s2[e] += v[e] * v[e];
      }
    }
  to_slots<VEC>(g, s1, s2, active, j, red_a, red_b);
  __syncthreads();
  float* own = part + 2 * rank * g.gib;
  group_reduce(g, red_a, red_b, g.slots, 1.f, own, own + g.gib);
  if (k > 1) {  // push this block's sums into its peers' `part`
    __syncthreads();
    cluster_wait();
    for (int i = t; i < 2 * g.gib; i += blockDim.x)
      for (int q = 0; q < k; ++q)
        if (q != rank) peer(own, q, k)[i] = own[i];
  }
  // after this barrier every rank's sums are local and no block touches
  // a peer's shared memory again, so each may run on and exit
  cluster_or_block_sync(k);
  for (int grp = t; grp < g.gib; grp += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < k; ++q) {
      a += part[2 * q * g.gib + grp];
      b += part[2 * q * g.gib + g.gib + grp];
    }
    const float cnt = (float)g.S * (float)g.gs;
    const float m = a / cnt;
    float var = b / cnt - m * m;
    var = var < 0.f ? 0.f : var;  // not fmaxf: a NaN variance stays NaN
    const float rs = rsqrtf(var + eps);
    stat[grp] = m;
    stat[g.gib + grp] = rs;
    if (rank == 0) {
      const size_t o = (size_t)n * g.G + c0 / g.gs + grp;
      mean_out[o] = m;
      rstd_out[o] = rs;
    }
  }
  __syncthreads();

  float m[VEC], rs[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int lg = (j * VEC + e) / g.gs;
    m[e] = stat[lg];
    rs[e] = stat[g.gib + lg];
  }
  if (active)
    for (int r = t / g.V; r < rows; r += g.rl) {
      unpack(*reinterpret_cast<const uint4*>(tile + r * g.cb + j * VEC), v, T());
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float z = norm_affine(v[e], m[e], rs[e], ga[e], be[e]);
        if (relu) z = z < 0.f ? 0.f : z;  // NaN passes through, as jnp.maximum
        v[e] = z;
      }
      *reinterpret_cast<uint4*>(y + base + (size_t)r * g.C) = pack(v, T());
    }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  T* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
                  Geom g, int relu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tx = reinterpret_cast<T*>(smem);
  T* tdy = tx + (size_t)g.rb * g.cb;
  float* red_a = reinterpret_cast<float*>(smem + 2 * (size_t)g.rb * g.cb * sizeof(T));
  float* red_b = red_a + g.slots * g.cb;
  const int k = gridDim.x, rank = blockIdx.x;
  float* chan = red_b + g.slots * g.cb;  // [2*cb]: this block's sum d*xhat, sum d
  float* stat = chan + 2 * g.cb;         // [2*gib]: mean(dz*xhat), mean(dz)
  const int n = blockIdx.z, c0 = blockIdx.y * g.cb;
  const int r0 = rank * g.rb, rows = max(0, min(g.S - r0, g.rb));
  const int t = threadIdx.x, j = t % g.V;
  const bool active = t < g.V * g.rl;
  const size_t base = (size_t)n * g.S * g.C + (size_t)r0 * g.C + c0 + j * VEC;

  if (active)
    for (int r = t / g.V; r < rows; r += g.rl) {
      cp_async16(tx + r * g.cb + j * VEC, x + base + (size_t)r * g.C);
      cp_async16(tdy + r * g.cb + j * VEC, dy + base + (size_t)r * g.C);
    }
  float ga[VEC], be[VEC], m[VEC], rs[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = c0 + j * VEC + e;
    ga[e] = gamma[c];
    be[e] = beta[c];
    m[e] = mean[(size_t)n * g.G + c / g.gs];
    rs[e] = rstd[(size_t)n * g.G + c / g.gs];
  }
  cp_async_wait_all();

  float pg[VEC], pb[VEC], xv[VEC], dv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) pg[e] = pb[e] = 0.f;
  if (active)
    for (int r = t / g.V; r < rows; r += g.rl) {
      unpack(*reinterpret_cast<const uint4*>(tx + r * g.cb + j * VEC), xv, T());
      unpack(*reinterpret_cast<const uint4*>(tdy + r * g.cb + j * VEC), dv, T());
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xv[e], m[e]), rs[e]);
        float d = dv[e];
        if (relu) d = (__fadd_rn(__fmul_rn(xh, ga[e]), be[e]) > 0.f) ? d : 0.f;
        pg[e] += d * xh;
        pb[e] += d;
      }
    }
  to_slots<VEC>(g, pg, pb, active, j, red_a, red_b);
  __syncthreads();
  for (int c = t; c < g.cb; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < g.slots; ++s) {
      a += red_a[s * g.cb + c];
      b += red_b[s * g.cb + c];
    }
    chan[c] = a;
    chan[g.cb + c] = b;
  }
  cluster_or_block_sync(k);
  // the cluster's per-channel sums, in rank order; red is free again
  for (int c = t; c < g.cb; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < k; ++q) {
      const float* p = peer(chan, q, k);
      a += p[c];
      b += p[g.cb + c];
    }
    if (rank == 0) {
      dgamma[(size_t)n * g.C + c0 + c] = a;
      dbeta[(size_t)n * g.C + c0 + c] = b;
    }
    const float gc = gamma[c0 + c];
    red_a[c] = gc * a;  // sum over the channel of dz * xhat
    red_b[c] = gc * b;  // sum over the channel of dz
  }
  // no block of the cluster reads a peer's `chan` after this barrier
  cluster_or_block_sync(k);
  group_reduce(g, red_a, red_b, 1, (float)g.S * (float)g.gs, stat, stat + g.gib);
  __syncthreads();

  float m2[VEC], m1[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int lg = (j * VEC + e) / g.gs;
    m2[e] = stat[lg];
    m1[e] = stat[g.gib + lg];
  }
  if (active)
    for (int r = t / g.V; r < rows; r += g.rl) {
      unpack(*reinterpret_cast<const uint4*>(tx + r * g.cb + j * VEC), xv, T());
      unpack(*reinterpret_cast<const uint4*>(tdy + r * g.cb + j * VEC), dv, T());
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xv[e], m[e]), rs[e]);
        float d = dv[e];
        if (relu) d = (__fadd_rn(__fmul_rn(xh, ga[e]), be[e]) > 0.f) ? d : 0.f;
        xv[e] = rs[e] * (d * ga[e] - m1[e] - xh * m2[e]);
      }
      *reinterpret_cast<uint4*>(dx + base + (size_t)r * g.C) = pack(xv, T());
    }
}

// Refuse a plan the kernels cannot run: every check here is one the
// plan in ops/group_norm.py already makes, so this fires only if the
// two disagree.
cudaError_t check_plan(const Geom& g, int N, int k, int elt, int bwd) {
  const bool ok = N >= 1 && N <= 65535 && g.S >= 1 && g.G >= 1 && g.C % g.G == 0 &&
                  g.gs >= 1 && g.cb >= g.vec && g.C % g.cb == 0 && g.cb % g.gs == 0 &&
                  g.cb % g.vec == 0 && g.V <= kMaxThreads && g.rb >= 1 && k >= 1 &&
                  k <= kMaxCluster && (size_t)k * g.rb >= (size_t)g.S &&
                  smem_bytes(g, elt, bwd, k) <= kMaxSmem;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, const Geom& g, int N, int k, size_t smem,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, g.C / g.cb, N);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launches on `stream` and
// returns a CUDA error code: a plan the kernel cannot run is refused
// with cudaErrorInvalidValue before launching, and a refused launch
// reports through cudaGetLastError (it never runs, and only this check
// sees it). The plan (cb channels and rb rows a block, k blocks a
// cluster) comes from gn_plan; threads and shared memory follow from it
// here (Geom, smem_bytes).
extern "C" int gn_fwd(const void* x, const float* gamma, const float* beta, void* y,
                      float* mean, float* rstd, int N, int S, int C, int G, int cb, int rb,
                      int k, float eps, int relu, int is_bf16, void* stream) {
  const int elt = is_bf16 ? 2 : 4;
  const Geom g(S, C, G, cb, rb, elt);
  cudaError_t err = check_plan(g, N, k, elt, 0);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(g, elt, 0, k);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(&attr, g, N, k, smem, (cudaStream_t)stream);
  if (is_bf16) {
    auto kern = gn_fwd_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, kern, (const __nv_bfloat16*)x, gamma, beta,
                               (__nv_bfloat16*)y, mean, rstd, g, eps, relu);
  } else {
    auto kern = gn_fwd_kernel<float>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, kern, (const float*)x, gamma, beta, (float*)y, mean, rstd,
                               g, eps, relu);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int gn_bwd(const void* x, const void* dy, const float* gamma, const float* beta,
                      const float* mean, const float* rstd, void* dx, float* dgamma,
                      float* dbeta, int N, int S, int C, int G, int cb, int rb, int k, int relu,
                      int is_bf16, void* stream) {
  const int elt = is_bf16 ? 2 : 4;
  const Geom g(S, C, G, cb, rb, elt);
  cudaError_t err = check_plan(g, N, k, elt, 1);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(g, elt, 1, k);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(&attr, g, N, k, smem, (cudaStream_t)stream);
  if (is_bf16) {
    auto kern = gn_bwd_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, kern, (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
                               gamma, beta, mean, rstd, (__nv_bfloat16*)dx, dgamma, dbeta, g,
                               relu);
  } else {
    auto kern = gn_bwd_kernel<float>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, kern, (const float*)x, (const float*)dy, gamma, beta, mean,
                               rstd, (float*)dx, dgamma, dbeta, g, relu);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
