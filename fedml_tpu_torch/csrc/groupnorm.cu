// GroupNorm forward and backward over trailing-channel activations, each
// (sample, group) spread over a thread-block cluster.
//
// Replaces the Pallas kernels of fedml_tpu/ops/groupnorm.py: _fwd_kernel
// (driven by _pallas_fwd) and _bwd_kernel (driven by _pallas_dx), and the
// dgamma/dbeta reduction beside them (_channel_grads).
//
// Layout: x is [N, S, C] in memory (S = H*W spatial positions, channels
// last), C = G groups of Cg = C/G channels. Statistics are f32; the
// variance is two-pass (below). gamma and beta (P) are bf16
// or f32, in any pairing with x (T); dgamma and dbeta come out in P.
//
// Bound on the H100: bytes. The forward reads x once and writes y once;
// the backward reads x and dy once and writes dx once. At 3.35 TB/s the
// forward of one [32, 32, 32, 64] bf16 layer is 2.5 us.
//
// Design. Each (sample, group) is one cluster of K <= 8 blocks (the
// portable cluster size); block rank r owns spatial rows
// [r * rows, (r + 1) * rows) of the group, all Cg channels. Thread t owns
// the VEC channels at column t % vpr (vpr = Cg / VEC) of rows
// t / vpr, t / vpr + rpp, ... (rpp = blockDim.x / vpr), so it loads its
// gamma and beta once. The launch plan (K, threads, rows, shared memory)
// comes from ops/groupnorm.py::launch_plan: at least one block per SM,
// about 16 KB of x and 128 threads a block, so the main path's 64 groups
// take clusters of 4 at stage 1 and of 3 after it (256 and 192 blocks).
//
// * Resident variant: a block copies its slice of x (and dy) from device
//   memory into shared memory once, in 16-byte vectors, and every later
//   pass reads it there, so each input byte crosses device memory once,
//   as in the Pallas kernel, which holds its block in VMEM.
// * Streaming variant: where a slice does not fit in a block's 227 KB
//   even at K = 8 (an ImageNet-sized stage; the main path has none), the
//   later passes re-read the slice from device memory (mostly L2). Same
//   code, RESIDENT = false; the plan chooses it by shape.
//
// Cluster reductions are deterministic: each block reduces its own
// values in a fixed order, writes the partial to its shared memory, and
// after cluster.sync() every block reads the K partials through
// distributed shared memory (the K loads issued together) and adds them
// in rank order, so every block (and every run) gets bitwise the same
// mean, rstd, s1 and s2. Each kernel makes one such exchange: a barrier
// round with its remote loads costs about a microsecond, as much as the
// rest of a small layer. So the forward's variance is two-pass inside
// each block, about the block's own mean over the values it holds, and
// the K blocks' (sum, sum of squares) are combined exactly with Chan et
// al.'s pairwise update, not by a second exchange of a second pass about
// the global mean; the backward's s1 and s2 come from each thread's own
// channel sums and gamma, beside the channel sums in the same exchange.
// Everything on the critical path after the exchange is shared memory
// or registers: gamma and beta are loaded beside x, and the finish's
// counter is bumped before the dx pass, so its round trip overlaps it.
//
// The backward finishes dgamma and dbeta in the same launch. Block rank r
// of each cluster adds the cluster's per-channel sums of dy*xhat and dy
// for its share of the group's channels (Cg / K of them), writes them to
// an [2, N, C] f32 scratch, fences, and bumps the counter of (group,
// rank); the block that brings it to N sums the N partials of its
// channels in the order n = 0..N-1, rounds once to P, and resets the
// counter. So the finish is spread over K blocks, the result does not
// depend on which block ends last, and no float atomic is used. (One
// counter per group, with the last cluster's first block summing all Cg
// channels, measured slower: at Cg = 256 that block's serial loads took
// longer than the rest of the kernel.) The counters are one buffer
// per device that the wrapper allocates zeroed once; they assume that no
// two backward launches on one device overlap, which holds for the
// port's single stream.
//
// A block must not exit while a peer may still read its shared memory:
// each block arrives on the cluster barrier after its last remote read
// and waits on it before it exits.
//
// Both kernels launch with programmatic dependent launch: the launch of
// a kernel is processed while the kernel before it in the stream drains,
// and its first instruction waits (griddepcontrol.wait) until that
// kernel has completed and its writes are visible, so nothing is read or
// written early. At these sizes a launch costs about as much as the
// work; this took about a microsecond off each on the H100. The kernels
// do not trigger their successors early: on the main path they follow
// and precede cuDNN and PyTorch kernels, which gain nothing from it.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace fedml {
namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr int kFinishBatch = 32;  // loads in flight per thread in the finish

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// Under programmatic dependent launch, wait until the previous kernel in
// the stream has completed and its writes are visible; a no-op otherwise.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// VEC elements of T moved as one raw load or store of at most 16 bytes
template <typename T, int VEC>
struct Pack {
  static_assert(sizeof(T) * VEC <= 16, "one vector is at most 16 bytes");
  using R = typename Raw<sizeof(T) * VEC>::type;
  R raw;
  __device__ __forceinline__ void load(const T* p) { raw = *reinterpret_cast<const R*>(p); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<R*>(p) = raw; }
  __device__ __forceinline__ void get(float (&out)[VEC]) const {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  }
};

// Where thread t of a block works: its (n, g), its rows and its channels.
struct Slice {
  int K, rank, n, g, Cg, vpr, rpp, col, row0, r_begin, r_end;
  bool active;
  __device__ Slice(cg::cluster_group& cluster, int S, int C, int G,
                   int rows, int vec) {
    K = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
    const int grp = blockIdx.x / K;
    n = grp / G;
    g = grp % G;
    Cg = C / G;
    vpr = Cg / vec;
    rpp = blockDim.x / vpr;
    col = threadIdx.x % vpr;
    row0 = threadIdx.x / vpr;
    active = (int)threadIdx.x < rpp * vpr;
    r_begin = rank * rows;
    r_end = min(S, r_begin + rows);
  }
};

// The sums of a and b over the block, in one pass (every thread of the
// block calls it and gets both, added in the same fixed order).
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float part[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  float ta = 0.f, tb = 0.f;
  for (int i = 0; i < n_warps; ++i) {
    ta += part[0][i];
    tb += part[1][i];
  }
  a = ta;
  b = tb;
}

// dynamic shared memory: RESIDENT ? rows * Cg elements of T : 0
template <typename T, typename P, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
              const P* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int S, int C, int G, int rows, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2];
  wait_for_previous_kernel();
  cg::cluster_group cluster = cg::this_cluster();
  const Slice w(cluster, S, C, G, rows, VEC);
  T* held = reinterpret_cast<T*>(smem);
  const long long base = (long long)w.n * S * C + (long long)w.g * w.Cg + w.col * VEC;
  const int hbase = w.col * VEC - w.r_begin * w.Cg;   // + r * Cg: row r of the slice
  const float m = (float)S * (float)w.Cg;

  // gamma and beta of this thread's channels, loaded beside x
  float ga[VEC], be[VEC];
  if (w.active) {
    const int c0 = w.g * w.Cg + w.col * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ga[i] = to_f32(gamma[c0 + i]);
      be[i] = to_f32(beta[c0 + i]);
    }
  }

  // pass 1: the only read of x from device memory; the block's sum
  float s = 0.f;
  if (w.active) {
#pragma unroll 4
    for (int r = w.r_begin + w.row0; r < w.r_end; r += w.rpp) {
      Pack<T, VEC> v;
      v.load(x + base + (long long)r * C);
      if constexpr (RESIDENT) v.store(held + hbase + r * w.Cg);
      float e[VEC];
      v.get(e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += e[i];
    }
  }
  s = block_sum(s);
  const float bmean = s / ((float)(w.r_end - w.r_begin) * (float)w.Cg);

  // pass 2, over the values held: the block's sum of squares about its
  // own mean (two-pass, as the reference's variance is)
  auto fetch = [&](int r, float (&e)[VEC]) {
    Pack<T, VEC> v;
    if constexpr (RESIDENT) v.load(held + hbase + r * w.Cg);
    else v.load(x + base + (long long)r * C);
    v.get(e);
  };
  float q = 0.f;
  if (w.active)
    for (int r = w.r_begin + w.row0; r < w.r_end; r += w.rpp) {
      float e[VEC];
      fetch(r, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = e[i] - bmean;
        q += d * d;
      }
    }
  q = block_sum(q);
  if (threadIdx.x == 0) {
    red[0] = s;
    red[1] = q;
  }
  cluster.sync();

  // one exchange: the K blocks' (sum, sum of squares about their mean),
  // loaded together and combined in rank order (Chan et al.'s pairwise
  // update, exact in real arithmetic: M2 = sum M2_r + n_r (mean_r - mean)^2)
  float sv[kMaxCluster], qv[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    const float* peer = r < w.K ? cluster.map_shared_rank(red, r) : red;
    sv[r] = r < w.K ? peer[0] : 0.f;
    qv[r] = r < w.K ? peer[1] : 0.f;
  }
  cluster_arrive();      // this block reads no peer's shared memory again
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < w.K) total += sv[r];
  const float mean = total / m;
  float m2 = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < w.K) {
      const float n_r = (float)(min(S, (r + 1) * rows) - r * rows) * (float)w.Cg;
      const float d = sv[r] / n_r - mean;
      m2 += qv[r] + n_r * d * d;
    }
  const float rstd = rsqrtf(m2 / m + eps);
  if (w.rank == 0 && threadIdx.x == 0) {
    mean_out[w.n * G + w.g] = mean;
    rstd_out[w.n * G + w.g] = rstd;
  }

  // pass 3: y = xhat * gamma + beta
  if (w.active)
    for (int r = w.r_begin + w.row0; r < w.r_end; r += w.rpp) {
      float e[VEC];
      fetch(r, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = (e[i] - mean) * rstd * ga[i] + be[i];
      store_vec<T, VEC>(y + base + (long long)r * C, e);
    }
  cluster_wait();        // peers are done with this block's shared memory
}

// Bytes of dynamic shared memory each region of the backward takes,
// rounded up to 16; launch_plan in ops/groupnorm.py computes the same.
__host__ __device__ constexpr int round16(long long b) { return (int)((b + 15) / 16 * 16); }

// dynamic shared memory, in this order: the held slices of x and dy
// (RESIDENT only, rows * Cg elements of T each), the per-row (or per-warp)
// channel partials (2 * rpp * Cg floats), the block's channel sums
// (2 * Cg floats). counter holds G * K arrival counts, one per (group,
// block rank).
template <typename T, typename P, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const P* __restrict__ gamma, const float* __restrict__ mean_in,
              const float* __restrict__ rstd_in, T* __restrict__ dx,
              P* __restrict__ dgamma, P* __restrict__ dbeta,
              float* __restrict__ part, unsigned int* __restrict__ counter,
              int N, int S, int C, int G, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2];
  __shared__ bool last;
  wait_for_previous_kernel();
  cg::cluster_group cluster = cg::this_cluster();
  const Slice w(cluster, S, C, G, rows, VEC);
  const int Cg = w.Cg;
  const int held_bytes = RESIDENT ? round16((long long)rows * Cg * sizeof(T)) : 0;
  T* hx = reinterpret_cast<T*>(smem);
  T* hdy = reinterpret_cast<T*>(smem + held_bytes);
  float* rowpart = reinterpret_cast<float*>(smem + 2 * held_bytes);
  float* chan = rowpart + 2 * w.rpp * Cg;       // [2][Cg]: dgamma, dbeta sums
  const long long base = (long long)w.n * S * C + (long long)w.g * Cg + w.col * VEC;
  const int hbase = w.col * VEC - w.r_begin * Cg;
  const float m = (float)S * (float)Cg;
  const float mean = mean_in[w.n * G + w.g], rstd = rstd_in[w.n * G + w.g];
  float gm[VEC];         // gamma of this thread's channels, loaded beside x
  if (w.active)
#pragma unroll
    for (int i = 0; i < VEC; ++i) gm[i] = to_f32(gamma[w.g * Cg + w.col * VEC + i]);

  // pass 1, the only read of x and dy from device memory: per-channel
  // sums over this thread's rows of dy*xhat and dy
  float pg[VEC], pb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) pg[i] = pb[i] = 0.f;
  if (w.active) {
#pragma unroll 2
    for (int r = w.r_begin + w.row0; r < w.r_end; r += w.rpp) {
      Pack<T, VEC> vx, vd;
      vx.load(x + base + (long long)r * C);
      vd.load(dy + base + (long long)r * C);
      if constexpr (RESIDENT) {
        vx.store(hx + hbase + r * Cg);
        vd.store(hdy + hbase + r * Cg);
      }
      float xe[VEC], de[VEC];
      vx.get(xe);
      vd.get(de);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        pg[i] += de[i] * ((xe[i] - mean) * rstd);
        pb[i] += de[i];
      }
    }
  }
  // this block's part of s1 = sum(dy*gamma) and s2 = sum(dy*gamma*xhat)
  float s1 = 0.f, s2 = 0.f;
  if (w.active)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1 += gm[i] * pb[i];
      s2 += gm[i] * pg[i];
    }
  // the block's channel sums: where a warp holds several rows of the same
  // columns (vpr divides 32), fold them with shuffles first, so that one
  // partial per warp, not per row, goes through shared memory
  int nrows = w.rpp, prow = w.row0;
  bool writes = w.active;
  if (w.vpr < 32 && 32 % w.vpr == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < w.vpr) break;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        pg[i] += __shfl_xor_sync(0xffffffffu, pg[i], o);
        pb[i] += __shfl_xor_sync(0xffffffffu, pb[i], o);
      }
    }
    nrows = blockDim.x / 32;
    prow = threadIdx.x / 32;
    writes = (threadIdx.x & 31) < w.vpr;
  }
  if (writes)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      rowpart[prow * Cg + w.col * VEC + i] = pg[i];
      rowpart[(nrows + prow) * Cg + w.col * VEC + i] = pb[i];
    }
  block_sum2(s1, s2);    // its __syncthreads also publishes rowpart
  for (int c = threadIdx.x; c < Cg; c += blockDim.x) {
    float dg = 0.f, db = 0.f;
    for (int rr = 0; rr < nrows; ++rr) {
      dg += rowpart[rr * Cg + c];
      db += rowpart[(nrows + rr) * Cg + c];
    }
    chan[c] = dg;
    chan[Cg + c] = db;
  }
  if (threadIdx.x == 0) {
    red[0] = s1;
    red[1] = s2;
  }
  cluster.sync();

  // one exchange: s1 and s2 over the cluster, and block rank r's share of
  // the channels, [c_lo, c_hi) (at most one channel a thread on the main
  // path's shapes): the K blocks' values, all loaded together and added
  // in rank order; the channel sums are written for the dgamma/dbeta
  // finish
  const int share = (Cg + w.K - 1) / w.K;
  const int c_lo = min(Cg, w.rank * share), c_hi = min(Cg, c_lo + share);
  const long long col0 = (long long)w.g * Cg;
  float v1[kMaxCluster], v2[kMaxCluster];
  int c = c_lo + threadIdx.x;
  {
    float vg[kMaxCluster], vb[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const bool in = r < w.K;
      const float* rp = in ? cluster.map_shared_rank(red, r) : red;
      const float* cp = in ? cluster.map_shared_rank(chan, r) : chan;
      v1[r] = in ? rp[0] : 0.f;
      v2[r] = in ? rp[1] : 0.f;
      vg[r] = in && c < c_hi ? cp[c] : 0.f;
      vb[r] = in && c < c_hi ? cp[Cg + c] : 0.f;
    }
    for (;;) {
      if (c < c_hi) {
        float dg = 0.f, db = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < w.K) {
            dg += vg[r];
            db += vb[r];
          }
        part[(long long)w.n * C + col0 + c] = dg;
        part[(long long)(N + w.n) * C + col0 + c] = db;
      }
      c += blockDim.x;
      if (c >= c_hi) break;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const float* cp = r < w.K ? cluster.map_shared_rank(chan, r) : chan;
        vg[r] = r < w.K ? cp[c] : 0.f;
        vb[r] = r < w.K ? cp[Cg + c] : 0.f;
      }
    }
  }
  cluster_arrive();      // this block reads no peer's shared memory again
  s1 = s2 = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < w.K) {
      s1 += v1[r];
      s2 += v2[r];
    }
  // arrive on the (group, rank) counter now, so that its round trip
  // overlaps the dx pass
  __threadfence();       // this block's partials are visible to the card
  __syncthreads();
  unsigned int* const count = counter + w.g * w.K + w.rank;
  unsigned int arrived = 0;
  if (threadIdx.x == 0) arrived = atomicAdd(count, 1u);

  // pass 2: dx = (dy*gamma - (s1 + xhat*s2)/m) * rstd
  if (w.active)
    for (int r = w.r_begin + w.row0; r < w.r_end; r += w.rpp) {
      Pack<T, VEC> vx, vd;
      if constexpr (RESIDENT) {
        vx.load(hx + hbase + r * Cg);
        vd.load(hdy + hbase + r * Cg);
      } else {
        vx.load(x + base + (long long)r * C);
        vd.load(dy + base + (long long)r * C);
      }
      float xe[VEC], de[VEC];
      vx.get(xe);
      vd.get(de);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (xe[i] - mean) * rstd;
        xe[i] = (de[i] * gm[i] - (s1 + xh * s2) / m) * rstd;
      }
      store_vec<T, VEC>(dx + base + (long long)r * C, xe);
    }

  // finish: of the N blocks of this rank in group g (one per sample), the
  // last to arrive sums their partials of its channel share in the order
  // n = 0..N-1, one thread per (channel, dgamma or dbeta), its loads
  // issued kFinishBatch at a time
  if (threadIdx.x == 0) last = arrived == (unsigned)(N - 1);
  __syncthreads();
  if (last) {
    __threadfence();
    for (int it = threadIdx.x; it < 2 * (c_hi - c_lo); it += blockDim.x) {
      const int c = c_lo + (it >> 1), which = it & 1;
      const float* src = part + (long long)which * N * C + col0 + c;
      float t = 0.f;
      for (int n0 = 0; n0 < N; n0 += kFinishBatch) {
        float v[kFinishBatch];
#pragma unroll
        for (int j = 0; j < kFinishBatch; ++j)
          v[j] = n0 + j < N ? __ldcg(src + (long long)(n0 + j) * C) : 0.f;
#pragma unroll
        for (int j = 0; j < kFinishBatch; ++j)
          if (n0 + j < N) t += v[j];
      }
      (which ? dbeta : dgamma)[col0 + c] = from_f32<P>(t);
    }
    if (threadIdx.x == 0) *count = 0u;   // ready for the next launch
  }
  cluster_wait();        // peers are done with this block's shared memory
}

// The dynamic shared memory a plan needs; the C entries refuse a plan
// that gives less.
int fwd_smem(int rows, int Cg, int esize, bool resident) {
  return resident ? round16((long long)rows * Cg * esize) : 0;
}
int bwd_smem(int rows, int Cg, int esize, int rpp, bool resident) {
  return 2 * fwd_smem(rows, Cg, esize, resident) + round16(2LL * rpp * Cg * 4) +
         round16(2LL * Cg * 4);
}

// Plan checks shared by both entries: the cluster covers S with rows per
// block and no empty block, the threads cover one row of vectors.
bool plan_ok(int S, int Cg, int vec, int K, int threads, int rows) {
  return vec >= 1 && K >= 1 && K <= kMaxCluster && threads >= 32 && threads <= kMaxThreads &&
         threads % 32 == 0 && Cg % vec == 0 && Cg / vec <= threads && rows >= 1 &&
         (long long)rows * K >= S && (long long)rows * (K - 1) < S;
}

// Launch one kernel instantiation as clusters of K blocks along x.
template <auto Kernel, typename... Args>
int launch_cluster(int clusters, int K, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    // once per instantiation and device: allow a block all its 227 KB
    static unsigned done = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 32 || !(done & (1u << dev))) {
      const cudaError_t e = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - 1024);
      if (e != cudaSuccess) return (int)e;
      if (dev < 32) done |= 1u << dev;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the launch may be processed while the
  // previous kernel in the stream drains; the kernel waits for it
  // (griddepcontrol.wait) before it touches memory
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(&cfg, Kernel, args...);
}

template <typename T> struct Type { using type = T; };

// vec is chosen by the Python wrapper: a power of two that divides Cg, at
// most 16 bytes of T, with every pointer of T aligned to vec * sizeof(T).
// The dispatch runs f on (T, P, VEC, RESIDENT) as types and constants.
template <typename F>
int dispatch(int dtype, int param_dtype, int vec, int resident, F&& f) {
  auto by_param = [&](auto t) -> int {
    using T = typename decltype(t)::type;
    auto by_vec = [&](auto p) -> int {
      auto go = [&](auto v) -> int {
        if (resident) f(t, p, v, std::true_type{});
        else f(t, p, v, std::false_type{});
        return 0;
      };
      switch (vec) {
        case 8:
          if constexpr (sizeof(T) <= 2) return go(std::integral_constant<int, 8>{});
          break;
        case 4: return go(std::integral_constant<int, 4>{});
        case 2: return go(std::integral_constant<int, 2>{});
        case 1: return go(std::integral_constant<int, 1>{});
      }
      return (int)cudaErrorInvalidValue;
    };
    if (param_dtype == kBFloat16) return by_vec(Type<__nv_bfloat16>{});
    if (param_dtype == kFloat32) return by_vec(Type<float>{});
    return (int)cudaErrorInvalidValue;
  };
  if (dtype == kBFloat16) return by_param(Type<__nv_bfloat16>{});
  if (dtype == kFloat32) return by_param(Type<float>{});
  return (int)cudaErrorInvalidValue;
}

int esize_of(int dtype) { return dtype == kBFloat16 ? 2 : 4; }

}  // namespace
}  // namespace fedml

using namespace fedml;

extern "C" int fedml_gn_fwd(const void* x, const void* gamma, const void* beta,
                            void* y, void* mean, void* rstd, int N, int S, int C,
                            int G, float eps, int dtype, int param_dtype, int vec,
                            int K, int threads, int rows, int smem, int resident,
                            void* stream) {
  const int Cg = C / G;
  if (G < 1 || C % G || !plan_ok(S, Cg, vec, K, threads, rows) ||
      smem < fwd_smem(rows, Cg, esize_of(dtype), resident) || smem > kMaxSmem - 1024)
    return (int)cudaErrorInvalidValue;
  int launch_rc = 0;
  const int rc = dispatch(dtype, param_dtype, vec, resident, [&](auto t, auto p, auto v, auto res) {
    using T = typename decltype(t)::type;
    using P = typename decltype(p)::type;
    launch_rc = launch_cluster<gn_fwd_kernel<T, P, decltype(v)::value, decltype(res)::value>>(
        N * G, K, threads, smem, static_cast<cudaStream_t>(stream), static_cast<const T*>(x),
        static_cast<const P*>(gamma), static_cast<const P*>(beta), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), S, C, G, rows, eps);
  });
  if (rc) return rc;
  if (launch_rc) return launch_rc;
  return (int)cudaGetLastError();
}

extern "C" int fedml_gn_bwd(const void* x, const void* dy, const void* gamma,
                            const void* mean, const void* rstd, void* dx,
                            void* dgamma, void* dbeta, void* part, void* counter,
                            int N, int S, int C, int G, int dtype, int param_dtype,
                            int vec, int K, int threads, int rows, int smem,
                            int resident, void* stream) {
  const int Cg = C / G;
  if (G < 1 || C % G || !plan_ok(S, Cg, vec, K, threads, rows) ||
      smem < bwd_smem(rows, Cg, esize_of(dtype), threads / (Cg / vec), resident) ||
      smem > kMaxSmem - 1024)
    return (int)cudaErrorInvalidValue;
  int launch_rc = 0;
  const int rc = dispatch(dtype, param_dtype, vec, resident, [&](auto t, auto p, auto v, auto res) {
    using T = typename decltype(t)::type;
    using P = typename decltype(p)::type;
    launch_rc = launch_cluster<gn_bwd_kernel<T, P, decltype(v)::value, decltype(res)::value>>(
        N * G, K, threads, smem, static_cast<cudaStream_t>(stream), static_cast<const T*>(x),
        static_cast<const T*>(dy), static_cast<const P*>(gamma),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<T*>(dx), static_cast<P*>(dgamma), static_cast<P*>(dbeta),
        static_cast<float*>(part), static_cast<unsigned int*>(counter), N, S, C, G, rows);
  });
  if (rc) return rc;
  if (launch_rc) return launch_rc;
  return (int)cudaGetLastError();
}
