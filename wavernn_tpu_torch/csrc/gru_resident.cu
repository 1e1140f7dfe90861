// GRU training recurrence for Hopper (sm_90a), redesigned around the rows
// of the batch: forward and backward, each one launch of thread-block
// clusters. A cluster owns a group of batch rows and runs all T steps for
// them on its own; its blocks hold the weights in shared memory, split by
// hidden units, and exchange each step's rows through distributed shared
// memory. No block waits on anything outside its cluster, so there is no
// grid barrier. Every B5 launch of the port runs here; csrc/gru_seq.cu, the
// first body, is the yardstick (the wrappers' private _legacy=True).
//
// Replaces: wavernn_tpu/ops/pallas_gru.py, _make_fwd_kernel (:57, called at
// :102) and _make_bwd_kernel (:122, called at :195), the two TPU kernels
// behind the custom VJP gru_seq_tm. ops/cuda_gru.py holds the wrappers, the
// launch plan's mirror (resident_gru_plan) and the plain versions.
//
// What it computes is gru_seq.cu's two functions, with its roundings (that
// file's head note has the equations): the streams in the input type, h
// rounded to it every step (ys[t] is the carry), bh read in f32, products
// accumulated in f32, the backward's dh carried in f32 and dgh read back
// in the stream type for the dh product. The sums run in another order
// than the first body's, so the two agree to rounding, not bit for bit.
//
// What bounds it. The work is small: at the vocoder's training shape (T
// 1375, B 32, H 512, f32) a step is 32 x 512 x 1536 FMAs, 0.75 us of the
// card's f32 rate, 1.03 ms a launch. The limit is the chain of T dependent
// steps. Row b's step t needs only row b's h_{t-1} (forward) or dgh[t]
// (backward): the rows of a batch are independent, so no step needs the
// whole grid, only the blocks that hold the weights. The first body met
// at a grid.sync() every step and staged the whole h_{t-1} (B x H) from L2
// into every block (PERF.md §6 has its per-stage split).
//
// Design (the plan: ops/cuda_gru.resident_gru_plan, here res_plan; the
// per-stage split that shaped it: tools/probe_b5_split.py, PERF.md §6):
//  1. Rows split over clusters. Cluster i owns R consecutive batch rows; R
//     is the batch over the clusters of C blocks the card holds at once
//     (cudaOccupancyMaxActiveClusters: 7 of 16 on an H100 SXM), so every
//     cluster runs at once at the training shapes. Launch by
//     cudaLaunchKernelEx with a cluster dimension (non-portable up to 16);
//     no cooperative launch. Each block asks for at least SMEM_FLOOR
//     bytes, so one block sits on each SM.
//  2. The cluster holds the weights, split by hidden units: block j of the
//     cluster owns units [jU, jU + U) with all three gates. Forward it
//     keeps wh's 3U columns of them (H x 3U); backward the matching 3U
//     rows of wh^T (3U x H, read from the transposed copy whT the wrapper
//     passes, so the load and the product's reads are contiguous in
//     units); in f32, for the whole launch. At H 512 that is 192 KB a
//     block in a cluster of 16. C is the smallest cluster size whose
//     blocks hold the weights, doubled while a block would hold more than
//     PREF_WEIGHTS bytes and B clusters of the larger size still fit (H
//     128: 4). A plan whose weights do not fit the largest cluster the
//     card grants keeps the first kres reduction indices' weights in
//     shared memory and reads the rest from device memory every step; no
//     shape raises.
//  3. Forward: block j needs the whole h_{t-1} row of each cluster row and
//     owns a slice of h_t. After a __syncthreads its lanes send the slice
//     to every peer at once by bulk copies (cp.async.bulk shared::cta to
//     shared::cluster) into the peer's tile for the next step, counted in
//     bytes on the peer's mbarrier for that step's parity; a block waits
//     on its mbarrier and its tile is whole. Two
//     tiles by step parity suffice: a block writes step t + 2's slice into
//     a peer only after it has that peer's step t + 1 slice, sent after
//     the peer's product of step t + 1 read the tile of step t.
//  4. Backward: the dh product turned around, a reduce-scatter. Block j
//     multiplies its own 3U columns of dgh[t] (its slice, local) by those
//     rows of wh^T for every unit, a partial dh of all H units, and sends
//     each peer the partial of the peer's units by st.async onto the
//     peer's mbarrier; a block sums the C partials of its units in rank
//     order. No block needs the whole dgh[t] row, so the tile is R x 3U,
//     not R x 3H, and a cluster of 16 holds five rows of a batch of 32.
//     A task carries two units (u, u + H / 2) where H allows, halving the
//     reads of the slice.
//  Where the slices do not tile the rows exactly (U % 4, C U != H), the
//  weights spill or the tiles do not fit, both directions pull instead:
//  barrier.cluster.arrive.release / wait.acquire, then ld through
//  map_shared_rank. The release waits for the block's outstanding memory
//  operations (about 900 cycles a step measured), which the mbarriers do
//  not.
//  5. Off the chain. The gate inputs of the next step (gi forward; sv,
//     ys[t-1] and dys backward) are loaded into registers while the
//     exchange is in flight, and bh stays in registers: each thread
//     consumes exactly the values it loads, so they need no staging
//     buffer in shared memory (cp.async into one would add a copy and a
//     barrier and hide nothing more). The outputs (ys, sv, dgi, dgh) are
//     plain stores issued after the exchange starts, which no peer waits
//     on. The backward's dh for a block's own (row, unit) pairs stays in
//     the registers of the thread that owns the pair; only dh0 is written.
//  6. The product. A task is (lane, group of RB rows, one of KS slices of
//     the reduction), RB all of a cluster's rows up to 8, so each weight
//     is read from shared memory once a step; the lanes of a warp take
//     consecutive units, so a weight load is one contiguous 128-byte row
//     and a tile load a broadcast. The forward's slices meet in shared
//     memory, the thread that owns a (row, unit) pair adding them in slice
//     order. With 32 units a block (the training shapes) the forward takes
//     a denser mapping, product_u32: a warp's half-warps split its slice,
//     each lane carries two units, so one 16-byte tile load serves both
//     halves and feeds 24 FMAs a lane (the tile's shared-memory wavefronts
//     were the product's largest cost; PERF.md §6). The same mapping for
//     the backward at H 512 (four units a lane) was slower: its partials
//     then leave by half the lanes.
// A forward step: product, __syncthreads, gates, the slice's copies, the
// streams' stores and the next inputs' loads, the mbarrier wait. A
// backward step: gates, __syncthreads, product and its st.async, stores and
// loads, the wait, the sum of the partials, __syncthreads.
// Not used yet: tensor cores (3xTF32), both directions of a BiGRU in one
// launch, TMA multicast of the weights.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int PMAX = 4;                       // (row, unit) pairs a thread owns
constexpr int64_t MAX_UNITS = PMAX * THREADS;  // units a block can own
constexpr int64_t SMEM_BUDGET = 232448;       // an H100 block's 227 KB
constexpr int64_t SMEM_FLOOR = 118784;        // two of these exceed an SM
constexpr int64_t PREF_WEIGHTS = 64 * 1024;   // see res_plan
constexpr int64_t MAX_CLUSTER = 16;
constexpr int MAX_RB = 8;                     // rows a task carries

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S> __device__ __forceinline__ S from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float lane4(const float4& v, int kk) {
  return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// distributed shared memory: a local shared address, its peer's copy, the
// mbarriers the pushed slices complete on, and bulk copies between them
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* mb, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(mb)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* mb, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(mb)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* mb, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(mb)), "r"(parity)
        : "memory");
  } while (!done);
}
// generic-proxy writes of shared memory made visible to the bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void bulk_s2s(uint32_t dst, uint32_t src, uint32_t bytes,
                                         uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

}  // namespace

// Mirrored field for field by ops/cuda_gru.py (ctypes): 8-byte fields only.
struct GruResFwdArgs {
  const void* gi;   // (T, B, 3H) S
  const void* wh;   // (H, 3H)    S
  const float* bh;  // (3H,)      f32
  const void* h0;   // (B, H)     S
  void* ys;         // (T, B, H)  S
  void* sv;         // (T, B, 4H) S
  int64_t T, B, H, bf16;
};

struct GruResBwdArgs {
  const void* sv;   // (T, B, 4H) S
  const void* ys;   // (T, B, H)  S
  const void* dys;  // (T, B, H)  S
  const void* whT;  // (3H, H)    S: wh transposed
  const void* h0;   // (B, H)     S
  void* dgi;        // (T, B, 3H) S
  void* dgh;        // (T, B, 3H) S
  float* dh0;       // (B, H)     f32
  int64_t T, B, H, bf16;
};

// The launch plan (ops/cuda_gru.RES_FIELDS, in this order).
struct GruResPlan {
  int64_t cluster;   // C: blocks a cluster
  int64_t clusters;  // clusters in the grid
  int64_t rows;      // R: batch rows a cluster owns
  int64_t rb;        // rows a task carries in registers (1 to MAX_RB)
  int64_t no;        // outputs a task: 3 forward (the gates), 1 or 2 backward
  int64_t units;     // U: hidden units a block owns
  int64_t klen;      // the reduction: H forward, 3H backward
  int64_t kp;        // klen rounded up to 4: the tile's row stride
  int64_t kres;      // reduction indices whose weights sit in shared memory
  int64_t tasks;     // P = U ceil(R / rb): (unit, row group) pairs
  int64_t ks;        // the reduction cut into KS slices
  int64_t kc;        // a slice's length, a multiple of 4
  int64_t push;      // 1: the exchange pushed onto the peers' mbarriers
                     // (forward: bulk copies of h_t slices; backward:
                     // st.async of the partials), 0: pulled after a cluster
                     // barrier
  int64_t smem;      // dynamic shared bytes a block
};

namespace {

// What a block of the plan runs, for U units and R rows:
//   forward:  the reduction over k < H (kp = H rounded up to 4), 3U weight
//             floats an index (wh's 3U columns), tasks over U lanes, KS
//             slices meeting in red; the tile holds the cluster's h rows
//             (R x kp), the exchange buffers its h_t slices (2 x R x U);
//   backward: the reduction over the block's own 3U columns of dgh (kp =
//             3U rounded up to 4), H weight floats an index (the rows of
//             wh^T, all H units), tasks over H / no lanes with no units
//             each (units u and u + H / 2 when no is 2: H even and at
//             least two units a thread), one slice; the tile holds the
//             block's dgh slice (R x kp), the exchange buffers its partial
//             dh of every unit (2 x R x H).
// The tile has ceil(R / rb) rb rows: a task carries rb rows.
struct Dims {
  int64_t kp, wpk, lanes, no, xb;
};
inline Dims dims_of(bool backward, int64_t H, int64_t U, int64_t R) {
  if (backward) {
    const int64_t no = H % 2 == 0 && H / 2 >= THREADS ? 2 : 1;
    return Dims{(3 * U + 3) / 4 * 4, H, H / no, no, 2 * R * H};
  }
  return Dims{(H + 3) / 4 * 4, 3 * U, U, 3, 2 * R * U};
}
// a task carries all the cluster's rows, up to MAX_RB: each weight is read
// from shared memory once a step
inline int64_t rb_of(int64_t R) { return R < MAX_RB ? R : MAX_RB; }
inline int64_t ks_of(bool backward, int64_t P) {
  return backward || P >= THREADS ? 1 : THREADS / P;
}
// shared floats of a plan besides the weights
inline int64_t other_floats(bool backward, int64_t H, int64_t U, int64_t R) {
  const Dims d = dims_of(backward, H, U, R);
  const int64_t rb = rb_of(R), rows = (R + rb - 1) / rb * rb, P = d.lanes * (rows / rb);
  const int64_t red = backward ? 0 : ks_of(false, P) * P * d.no * rb;
  return rows * d.kp + d.xb + red;
}

// The plan for B rows of H units on a card with `sms` SMs whose largest
// cluster is max_cluster blocks and which holds `active` clusters of the
// chosen size at once (0: sms / C). Pure host arithmetic, mirrored by
// ops/cuda_gru.resident_gru_plan. Returns false only for a shape no
// cluster can hold a single row of.
bool res_plan(int64_t B, int64_t H, bool backward, int64_t sms, int64_t max_cluster,
              int64_t active, GruResPlan* out) {
  const int64_t budget = SMEM_BUDGET / 4;
  if (max_cluster > MAX_CLUSTER) max_cluster = MAX_CLUSTER;
  if (max_cluster < 1) max_cluster = 1;
  if (sms < 1) sms = 1;
  auto units_of = [&](int64_t c) { return (H + c - 1) / c; };
  auto weights_of = [&](int64_t c) {
    const Dims d = dims_of(backward, H, units_of(c), 1);
    return d.kp * d.wpk;
  };
  // C: the smallest cluster whose blocks hold the weights beside one row;
  // then larger while a block would hold more than PREF_WEIGHTS bytes of
  // them and B clusters of the larger size still fit one block an SM
  int64_t C = 0;
  for (int64_t c = 1; c <= max_cluster; c *= 2) {
    if (units_of(c) > MAX_UNITS) continue;
    if (weights_of(c) + other_floats(backward, H, units_of(c), 1) <= budget) {
      C = c;
      break;
    }
  }
  if (C == 0) {  // the weights spill: the largest cluster, fewest units a block
    for (int64_t c = 1; c <= max_cluster; c *= 2)
      if (units_of(c) <= MAX_UNITS) C = c;
    if (C == 0) return false;
  } else {
    while (2 * C <= max_cluster && 4 * weights_of(C) > PREF_WEIGHTS && B * 2 * C <= sms)
      C *= 2;
  }
  const int64_t U = units_of(C);
  if (U > MAX_UNITS) return false;
  const int64_t A = active > 0 ? active : (sms / C > 0 ? sms / C : 1);
  // R: the rows over the clusters the card holds at once, cut to what the
  // shared memory and the pairs a thread owns allow
  int64_t R = (B + A - 1) / A;
  if (R < 1) R = 1;
  const int64_t wfull = weights_of(C);
  const bool resident = wfull + other_floats(backward, H, U, 1) <= budget;
  while (R > 1 && (R * U > MAX_UNITS ||
                   (resident ? wfull : 0) + other_floats(backward, H, U, R) > budget))
    --R;
  if (other_floats(backward, H, U, R) > budget) return false;
  int64_t N = (B + R - 1) / R;
  if (N < 1) N = 1;
  R = (B + N - 1) / N;  // the same clusters, rows spread evenly
  if (R < 1) R = 1;
  const Dims d = dims_of(backward, H, U, R);
  GruResPlan p;
  p.cluster = C;
  p.clusters = N;
  p.rows = R;
  p.rb = rb_of(R);
  p.no = d.no;
  p.units = U;
  p.klen = backward ? 3 * U : H;
  p.kp = d.kp;
  const int64_t free_f = budget - other_floats(backward, H, U, R);
  p.kres = resident ? d.kp : (free_f / d.wpk) / 4 * 4;
  if (p.kres > d.kp) p.kres = d.kp;
  p.tasks = d.lanes * ((R + p.rb - 1) / p.rb);
  p.ks = ks_of(backward, p.tasks);
  int64_t bytes = 4 * (p.kres * d.wpk + other_floats(backward, H, U, R));
  // the forward pushes where the slices tile the rows exactly, the weights
  // are resident and two tiles fit, with at most half the slices given up
  p.push = 0;
  if (backward && resident && U % 4 == 0 && C * U == H && bytes / 4 + 4 <= budget) {
    p.push = 1;  // the partials by st.async, two mbarriers after the buffers
    bytes += 16;
  }
  if (!backward && resident && U % 4 == 0 && C * U == H) {
    const int64_t rows = (R + p.rb - 1) / p.rb * p.rb;
    auto need = [&](int64_t ks) {
      return d.kp * d.wpk + 2 * C * rows * U + (ks * p.tasks * 3 * p.rb + 1) / 2 * 2 + 4;
    };
    int64_t ks = p.ks;
    while (ks > (p.ks + 1) / 2 && need(ks) > budget) --ks;
    if (need(ks) <= budget) {
      p.push = 1;
      p.ks = ks;
      bytes = 4 * need(ks);
    }
  }
  p.kc = ((d.kp + p.ks - 1) / p.ks + 3) / 4 * 4;
  p.smem = (bytes + 15) / 16 * 16;
  if (p.smem < SMEM_FLOOR) p.smem = SMEM_FLOOR;
  *out = p;
  return true;
}

// The rows a product reads: element (row i, reduction index k) at base +
// i rs + (k / ub) bs + k % ub. A tile of whole rows has ub = kp (bs
// unused); the forward's pushed tile is source-major, one (rows, U) slice
// a block: rs = U, ub = U, bs = rows U.
struct Rows {
  const float* base;
  int rs, ub, bs;
};

// acc[g][i] += sum over k in [k0, k1) of w(k, g) rows[i][k], the weights
// from shared memory (ws: (k, g, lane) with the lane fastest, `lanes` of
// them) or from device memory through wg(k, g). k0, k1: multiples of 4.
template <int NO, int RB>
__device__ __forceinline__ void dots_smem(float (&acc)[NO][RB], const float* __restrict__ ws,
                                          int lanes, int u, const Rows& t, int k0, int k1) {
  for (int k = k0; k < k1;) {
    const int j = k / t.ub, kend = min(k1, (j + 1) * t.ub);
    const float* tb = t.base + (size_t)j * t.bs - (size_t)j * t.ub;
#pragma unroll 2
    for (; k < kend; k += 4) {
      float4 hv[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        hv[i] = *reinterpret_cast<const float4*>(tb + (size_t)i * t.rs + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* w = ws + (size_t)(k + kk) * NO * lanes + u;
        float wv[NO];
#pragma unroll
        for (int g = 0; g < NO; ++g) wv[g] = w[g * lanes];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float h = lane4(hv[i], kk);
#pragma unroll
          for (int g = 0; g < NO; ++g) acc[g][i] = fmaf(h, wv[g], acc[g][i]);
        }
      }
    }
  }
}

// the same from device memory; only tiles of whole rows (ub = kp)
template <int NO, int RB, typename WG>
__device__ __forceinline__ void dots_global(float (&acc)[NO][RB], const WG& wg, const Rows& t,
                                            int k0, int k1) {
  for (int k = k0; k < k1; k += 4) {
    float wv[4][NO];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < NO; ++g) wv[kk][g] = wg(k + kk, g);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float4 hv = *reinterpret_cast<const float4*>(t.base + (size_t)i * t.rs + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < NO; ++g) acc[g][i] = fmaf(lane4(hv, kk), wv[kk][g], acc[g][i]);
    }
  }
}

// One step's product over the rows: task (lane u, row group rg, slice ks)
// sums its slice and hands acc to emit(ks, pp, rg, u, acc). All threads.
template <int NO, int RB, typename WG, typename EMIT>
__device__ __forceinline__ void product(const GruResPlan& p, int lanes, const float* ws,
                                        const Rows& rows, const WG& wg, const EMIT& emit) {
  const int P = (int)p.tasks, KS = (int)p.ks, KC = (int)p.kc;
  const int KP = (int)p.kp, KRES = (int)p.kres;
  for (int task = threadIdx.x; task < P * KS; task += THREADS) {
    const int pp = task % P, ks = task / P;
    const int u = pp % lanes, rg = pp / lanes;
    const int k0 = ks * KC, k1 = min(KP, k0 + KC);
    float acc[NO][RB];
#pragma unroll
    for (int g = 0; g < NO; ++g)
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[g][i] = 0.f;
    const Rows t = {rows.base + (size_t)rg * RB * rows.rs, rows.rs, rows.ub, rows.bs};
    const int ke = min(k1, KRES);
    if (k0 < ke) dots_smem<NO, RB>(acc, ws, lanes, u, t, k0, ke);
    const int kg = max(k0, KRES);
    if (kg < k1)
      dots_global<NO, RB>(acc, [&](int k, int g) { return wg(k, g, u); }, t, kg, k1);
    emit(ks, pp, rg, u, acc);
  }
}

// The forward's product where a block owns 32 units, the weights are
// resident and one task carries all the rows: warp w takes slice w of the
// reduction, its half-warps the slice's two halves, lane l of each half
// units l and l + 16 with all three gates, the halves summed by a shuffle.
// A tile load (16 bytes, one address a half-warp) then feeds 24 FMAs a
// lane for two halves at once, half the tile's shared-memory wavefronts
// of product()'s mapping; the weights are float4 of four reduction
// indices (ws4: (k / 4, gate, unit)), 128 contiguous bytes a quarter-warp.
// The partial sums land in red as product() and emit leave them.
template <int RB>
__device__ __forceinline__ void product_u32(const GruResPlan& p, const float4* __restrict__ ws4,
                                            const Rows& t, float* red) {
  const int KS = (int)p.ks, KC = (int)p.kc, KP = (int)p.kp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= KS) return;
  const int half = lane >> 4, ul = lane & 15;
  const int k0 = warp * KC, k1 = min(KP, k0 + KC);
  const int mid = min(k1, k0 + (k1 - k0 + 7) / 8 * 4);
  const int ka = half ? mid : k0, kb = half ? k1 : mid;
  float acc[2][3][RB];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[jj][g][i] = 0.f;
  for (int k = ka; k < kb;) {
    const int j = k / t.ub, kend = min(kb, (j + 1) * t.ub);
    const float* tb = t.base + (size_t)j * t.bs - (size_t)j * t.ub;
#pragma unroll 2
    for (; k < kend; k += 4) {
      float4 hv[RB], w[3][2];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        hv[i] = *reinterpret_cast<const float4*>(tb + (size_t)i * t.rs + k);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) w[g][jj] = ws4[(k >> 2) * 96 + g * 32 + ul + 16 * jj];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float h = lane4(hv[i], kk);
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              acc[jj][g][i] = fmaf(h, lane4(w[g][jj], kk), acc[jj][g][i]);
        }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        acc[jj][g][i] += __shfl_xor_sync(0xffffffffu, acc[jj][g][i], 16);
        if (half == 0) red[((size_t)(warp * 3 + g) * RB + i) * 32 + ul + 16 * jj] = acc[jj][g][i];
      }
}

// The forward's partial sums: red is (KS, 3, RB, P), p fastest. The sums
// over the slices of the three outputs of pair (row b, unit u), in slice
// order, eight slices' loads in flight at a time.
template <int RB>
__device__ __forceinline__ void red_sums(const GruResPlan& p, const float* red, int b, int u,
                                         float (&s)[3]) {
  const int P = (int)p.tasks, KS = (int)p.ks;
  const size_t gs = (size_t)RB * P, kss = 3 * gs;
  const float* r0 = red + (size_t)(b % RB) * P + (b / RB) * (int)p.units + u;
  s[0] = s[1] = s[2] = 0.f;
  for (int ks = 0; ks < KS; ks += 8) {
    float v[8][3];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g) v[j][g] = ks + j < KS ? r0[(ks + j) * kss + g * gs] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g) s[g] += v[j][g];
  }
}

// Every peer's h_t slice (buffer xbuf, (R, U) a block) into the tile:
// column j U + u of row b. 16-byte loads where the slices tile the row.
__device__ __forceinline__ void gather(const GruResPlan& p, cg::cluster_group& cluster,
                                       float* xbuf, float* tile, int nb, int H) {
  const int C = (int)p.cluster, U = (int)p.units, KP = (int)p.kp;
  constexpr int GL = 4;  // loads in flight a thread
  if (U % 4 == 0 && C * U == H) {
    const int U4 = U / 4, per = nb * U4, tot = C * per;
    for (int e0 = threadIdx.x; e0 < tot; e0 += THREADS * GL) {
      float4 v[GL];
#pragma unroll
      for (int i = 0; i < GL; ++i) {
        const int e = e0 + i * THREADS, j = e / per, r = e - j * per;
        if (e < tot)
          v[i] = reinterpret_cast<const float4*>(cluster.map_shared_rank(xbuf, (unsigned)j))[r];
      }
#pragma unroll
      for (int i = 0; i < GL; ++i) {
        const int e = e0 + i * THREADS, j = e / per, r = e - j * per, b = r / U4;
        if (e < tot)
          *reinterpret_cast<float4*>(tile + (size_t)b * KP + j * U + 4 * (r - b * U4)) = v[i];
      }
    }
  } else {
    const int per = nb * U, tot = C * per;
    for (int e = threadIdx.x; e < tot; e += THREADS) {
      const int j = e / per, r = e - j * per, b = r / U, u = r - b * U;
      if (j * U + u >= H) continue;
      const float* src = cluster.map_shared_rank(xbuf, (unsigned)j);
      tile[(size_t)b * KP + j * U + u] = src[b * U + u];
    }
  }
}

template <typename S, int RB>
__global__ void __launch_bounds__(THREADS, 1) gru_res_fwd(GruResFwdArgs a, GruResPlan p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int T = (int)a.T, B = (int)a.B, H = (int)a.H;
  const int C = (int)p.cluster, U = (int)p.units, R = (int)p.rows, KP = (int)p.kp;
  const int KRES = (int)p.kres, P = (int)p.tasks, KS = (int)p.ks;
  const bool push = p.push != 0;
  const int rank = (int)(blockIdx.x % C), cid = (int)(blockIdx.x / C);
  const int u0 = rank * U, nu = max(0, min(U, H - u0));
  const int b0 = cid * R, nb = max(0, min(R, B - b0));
  const int NRG = (R + RB - 1) / RB, RP = NRG * RB;
  // pull: one tile of whole rows (RP, KP) and the exchange buffers (2, R,
  // U); push: two source-major tiles (C, RP, U) by step parity, and the
  // mbarriers their slices arrive on
  const size_t tsz = push ? (size_t)C * RP * U : (size_t)RP * KP;
  float* ws = smem;                                   // (KRES, 3, U)
  float* tile = ws + (size_t)KRES * 3 * U;
  float* xb = tile + (push ? 2 : 1) * tsz;            // pull only
  float* red = push ? xb : xb + (size_t)2 * R * U;    // (KS, 3, RB, P)
  uint64_t* mbar = reinterpret_cast<uint64_t*>(red + ((size_t)KS * 3 * RB * P + 1) / 2 * 2);
  const int tid = threadIdx.x;
  const S* gi = (const S*)a.gi;
  const S* wh = (const S*)a.wh;
  const S* h0 = (const S*)a.h0;
  S* ys = (S*)a.ys;
  S* sv = (S*)a.sv;
  // where (row b, unit k) of h sits in a tile
  auto at = [&](float* t, int b, int k) -> float& {
    if (!push) return t[(size_t)b * KP + k];
    const int j = k / U;
    return t[((size_t)j * RP + b) * U + k - j * U];
  };

  // 32 units a block, resident weights, one row group: product_u32, the
  // weights as float4 of four reduction indices
  const bool u32 = U == 32 && NRG == 1 && KRES == KP;
  for (int e = tid; e < KRES * 3 * U; e += THREADS) {
    const int k = e / (3 * U), r = e - k * 3 * U, g = r / U, u = r - g * U;
    ws[u32 ? ((size_t)(k >> 2) * 3 * U + r) * 4 + (k & 3) : (size_t)e] =
        k < H && u < nu ? to_f(wh[(size_t)k * 3 * H + g * H + u0 + u]) : 0.f;
  }
  for (size_t e = tid; e < (push ? 2 : 1) * tsz; e += THREADS) tile[e] = 0.f;
  if (!push)
    for (int e = tid; e < 2 * R * U; e += THREADS) xb[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < nb * H; e += THREADS) {
    const int b = e / H, k = e - b * H;
    at(tile, b, k) = to_f(h0[(size_t)(b0 + b) * H + k]);
  }
  if (push && tid == 0) {
    mbar_init(&mbar[0], 1);
    mbar_init(&mbar[1], 1);
    fence_mbar_init();
  }
  // every block of the cluster running, its buffers and mbarriers set,
  // before any peer reads or writes them
  cluster.sync();

  // the (row, unit) pairs this thread owns, and their gi a step ahead
  float pg[PMAX][3];
  auto load_gi = [&](int t) {
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int q = tid + i * THREADS, b = q / U, u = q - b * U;
      if (b < nb && u < nu) {
        const S* g = gi + ((size_t)t * B + b0 + b) * 3 * H + u0 + u;
        pg[i][0] = to_f(g[0]);
        pg[i][1] = to_f(g[H]);
        pg[i][2] = to_f(g[2 * H]);
      }
    }
  };
  if (T > 0) load_gi(0);
  // the pairs' bh, in registers for the whole launch
  float bhr[PMAX][3];
#pragma unroll
  for (int i = 0; i < PMAX; ++i) {
    const int q = tid + i * THREADS, b = q / U, u = q - b * U;
#pragma unroll
    for (int g = 0; g < 3; ++g) bhr[i][g] = b < nb && u < nu ? a.bh[g * H + u0 + u] : 0.f;
  }
  auto wg = [&](int k, int g, int u) {
    return k < H && u < nu ? to_f(wh[(size_t)k * 3 * H + g * H + u0 + u]) : 0.f;
  };
  auto emit = [&](int ks, int pp, int, int, const float(&acc)[3][RB]) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < RB; ++i) red[((size_t)(ks * 3 + g) * RB + i) * P + pp] = acc[g][i];
  };

  float o[PMAX][5];  // the pairs' h, r, z, n, hn: stored after the exchange starts
  for (int t = 0; t < T; ++t) {
    float* cur = push && (t & 1) ? tile + tsz : tile;   // h_{t-1}
    float* nxt = push && !(t & 1) ? tile + tsz : tile;  // h_t (push)
    float* xbuf = xb + (size_t)(t & 1) * R * U;         // h_t slice (pull)
    const Rows rows = push ? Rows{cur, U, U, RP * U} : Rows{cur, KP, KP, 0};
    if (u32)
      product_u32<RB>(p, reinterpret_cast<const float4*>(ws), rows, red);
    else
      product<3, RB>(p, U, ws, rows, wg, emit);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int q = tid + i * THREADS, b = q / U, u = q - b * U;
      if (b < nb && u < nu) {
        const int j = u0 + u;
        float gh[3];
        red_sums<RB>(p, red, b, u, gh);
        const float hr = gh[0] + bhr[i][0];
        const float hz = gh[1] + bhr[i][1];
        const float hn = gh[2] + bhr[i][2];
        const float r = sigmoidf(pg[i][0] + hr);
        const float z = sigmoidf(pg[i][1] + hz);
        const float n = tanhf(pg[i][2] + r * hn);
        // the own unit's place in a tile: slice `rank` (push) or column j
        const size_t own = push ? ((size_t)rank * RP + b) * U + u : (size_t)b * KP + j;
        const float h = (1.f - z) * n + z * cur[own];
        if (push)
          nxt[own] = to_f(from_f<S>(h));
        else
          xbuf[b * U + u] = to_f(from_f<S>(h));
        o[i][0] = h;
        o[i][1] = r;
        o[i][2] = z;
        o[i][3] = n;
        o[i][4] = hn;
      }
    }
    if (push) {
      // the block's h_t slice to every peer's next tile by bulk copies, the
      // bytes counted on the peer's mbarrier of that parity: lane 0 of warp
      // 0 posts the count due here, lane l < C copies to the peer l ranks
      // on, all at once (copies issued a warp apiece cost more)
      if (t + 1 < T) {
        fence_proxy_async();
        __syncthreads();
        if (tid < C) {
          uint64_t* mb = &mbar[(t + 1) & 1];
          if (tid == 0) {
            mbar_expect_tx(mb, (uint32_t)((C - 1) * nb * U * 4));
          } else {
            const uint32_t src = smem_u32(nxt + (size_t)rank * RP * U);
            const uint32_t peer = (uint32_t)((rank + tid) % C);
            bulk_s2s(map_rank(src, peer), src, (uint32_t)(nb * U * 4),
                     map_rank(smem_u32(mb), peer));
          }
        }
      }
    } else {
      cluster_arrive();
    }
    // the streams' stores after the exchange starts: the arrive's release
    // waits for none of them
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int q = tid + i * THREADS, b = q / U, u = q - b * U;
      if (b < nb && u < nu) {
        const int j = u0 + u;
        const size_t row = (size_t)t * B + b0 + b;
        ys[row * H + j] = from_f<S>(o[i][0]);
        S* s = sv + row * 4 * H;
        s[j] = from_f<S>(o[i][1]);
        s[H + j] = from_f<S>(o[i][2]);
        s[2 * H + j] = from_f<S>(o[i][3]);
        s[3 * H + j] = from_f<S>(o[i][4]);
      }
    }
    if (t + 1 < T) load_gi(t + 1);
    if (push) {
      // h_t's phase of this parity is the (t / 2)-th
      if (t + 1 < T) mbar_wait(&mbar[(t + 1) & 1], (uint32_t)((t >> 1) & 1));
    } else {
      cluster_wait();
      // the last step's barrier is the exit's: no peer reads this block's
      // buffers after it
      if (t + 1 < T) {
        gather(p, cluster, xbuf, tile, nb, H);
        __syncthreads();
      }
    }
  }
  // push: no block leaves while a copy into or out of it may be in flight
  if (push) cluster.sync();
}

// The backward turns the dh product around: block j multiplies its own
// 3U columns of dgh[t] (its slice, local) by the matching rows of wh^T for
// every unit, giving a partial dh of all H units; each block then sums
// the C partials of its own units from its peers (a reduce-scatter in
// distributed shared memory). No block needs the whole dgh[t] row, so the
// tile is R x 3U, not R x 3H, and a cluster holds more rows.
template <typename S, int RB, int NO>
__global__ void __launch_bounds__(THREADS, 1) gru_res_bwd(GruResBwdArgs a, GruResPlan p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int T = (int)a.T, B = (int)a.B, H = (int)a.H, G = 3 * H;
  const int C = (int)p.cluster, U = (int)p.units, R = (int)p.rows, KP = (int)p.kp;
  const int KRES = (int)p.kres;
  const int rank = (int)(blockIdx.x % C), cid = (int)(blockIdx.x / C);
  const int u0 = rank * U, nu = max(0, min(U, H - u0));
  const int b0 = cid * R, nb = max(0, min(R, B - b0));
  const int NRG = (R + RB - 1) / RB;
  float* ws = smem;                                   // (KRES, H): wh[u'][col(c)]
  float* tile = ws + (size_t)KRES * H;                // (NRG RB, KP): dgh slice
  // the partial dh by step parity: pull (2, R, H), every unit of this
  // block's; push (2, C, R, U), this block's units from every peer
  float* xb = tile + (size_t)NRG * RB * KP;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(xb + (size_t)2 * R * H);  // push
  const bool push = p.push != 0;
  const int tid = threadIdx.x;
  const S* whT = (const S*)a.whT;
  const S* svp = (const S*)a.sv;
  const S* ysp = (const S*)a.ys;
  const S* dysp = (const S*)a.dys;
  const S* h0 = (const S*)a.h0;
  S* dgi = (S*)a.dgi;
  S* dgh = (S*)a.dgh;

  // own column c = g U + u is dgh's column g H + u0 + u
  for (int e = tid; e < KRES * H; e += THREADS) {
    const int c = e / H, v = e - c * H, g = c / U, u = c - g * U;
    ws[e] = g < 3 && u < nu ? to_f(whT[(size_t)(g * H + u0 + u) * H + v]) : 0.f;
  }
  for (int e = tid; e < NRG * RB * KP; e += THREADS) tile[e] = 0.f;
  for (int e = tid; e < 2 * R * H; e += THREADS) xb[e] = 0.f;
  if (push && tid == 0) {
    mbar_init(&mbar[0], 1);
    mbar_init(&mbar[1], 1);
    fence_mbar_init();
  }
  cluster.sync();

  // the pairs' gate inputs of step t, loaded a step ahead: [r, z, n, hn]
  // from sv, h_{t-1} (ys[t-1] or h0) and dys[t]
  float in[PMAX][6], dh[PMAX], dtz[PMAX];
  float o[PMAX][4];  // the pairs' dpre_r, dpre_z, dpre_n, dhn: stored after the arrive
  auto load_in = [&](int t) {
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int q = tid + i * THREADS, b = q / U, u = q - b * U;
      if (b < nb && u < nu) {
        const int j = u0 + u;
        const size_t row = (size_t)t * B + b0 + b;
        const S* s = svp + row * 4 * H + j;
        in[i][0] = to_f(s[0]);
        in[i][1] = to_f(s[H]);
        in[i][2] = to_f(s[2 * H]);
        in[i][3] = to_f(s[3 * H]);
        in[i][4] = t > 0 ? to_f(ysp[(row - B) * H + j]) : to_f(h0[(size_t)(b0 + b) * H + j]);
        in[i][5] = to_f(dysp[row * H + j]);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < PMAX; ++i) dh[i] = dtz[i] = 0.f;
  if (T > 0) load_in(T - 1);
  const int lanes = H / NO;  // task lane u computes units u + o lanes, o < NO
  auto wg = [&](int c, int o, int lane) {
    const int g = c / U, u = c - g * U;
    return g < 3 && u < nu ? to_f(whT[(size_t)(g * H + u0 + u) * H + o * lanes + lane]) : 0.f;
  };

  for (int t = T - 1; t >= 0; --t) {
    float* xbuf = xb + (size_t)(t & 1) * R * H;
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int q = tid + i * THREADS, b = q / U, u = q - b * U;
      if (b < nb && u < nu) {
        const int j = u0 + u;
        const float r = in[i][0], z = in[i][1], n = in[i][2], hn = in[i][3];
        const float dtot = dh[i] + in[i][5];
        const float dz = dtot * (in[i][4] - n);
        const float dn = dtot * (1.f - z);
        const float dpre_n = dn * (1.f - n * n);
        const float dhn = dpre_n * r;
        const float dpre_r = (dpre_n * hn) * r * (1.f - r);
        const float dpre_z = dz * z * (1.f - z);
        float* x = tile + (size_t)b * KP + u;
        x[0] = to_f(from_f<S>(dpre_r));
        x[U] = to_f(from_f<S>(dpre_z));
        x[2 * U] = to_f(from_f<S>(dhn));
        o[i][0] = dpre_r;
        o[i][1] = dpre_z;
        o[i][2] = dpre_n;
        o[i][3] = dhn;
        dtz[i] = dtot * z;
      }
    }
    __syncthreads();
    // partial dh of every unit from this block's columns, into xbuf
    // (push: straight into the owner's buffer, st.async onto its mbarrier)
    uint64_t* mb = &mbar[t & 1];
    if (push && tid == 0) mbar_expect_tx(mb, (uint32_t)(C * nb * U * 4));
    product<NO, RB>(p, lanes, ws, Rows{tile, KP, KP, 0}, wg,
                    [&](int, int, int rg, int v, const float(&acc)[NO][RB]) {
                      if (push) {
#pragma unroll
                        for (int o = 0; o < NO; ++o) {
                          const int w = o * lanes + v, k = w / U, u = w - k * U;
                          const uint32_t dst = map_rank(
                              smem_u32(xbuf + ((size_t)rank * R + rg * RB) * U + u), k);
                          const uint32_t mk = map_rank(smem_u32(mb), k);
#pragma unroll
                          for (int i = 0; i < RB; ++i)
                            if (rg * RB + i < nb) st_async(dst + 4 * i * U, acc[o][i], mk);
                        }
                      } else {
#pragma unroll
                        for (int o = 0; o < NO; ++o)
#pragma unroll
                          for (int i = 0; i < RB; ++i)
                            if (rg * RB + i < R)
                              xbuf[(size_t)(rg * RB + i) * H + o * lanes + v] = acc[o][i];
                      }
                    });
    if (!push) cluster_arrive();
    // the streams' stores after the arrive, so its release waits for none
    // of them
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int q = tid + i * THREADS, b = q / U, u = q - b * U;
      if (b < nb && u < nu) {
        const int j = u0 + u;
        const size_t row = (size_t)t * B + b0 + b;
        S* gi_row = dgi + row * G;
        S* gh_row = dgh + row * G;
        const S sr = from_f<S>(o[i][0]), sz = from_f<S>(o[i][1]);
        gi_row[j] = sr;
        gi_row[H + j] = sz;
        gi_row[2 * H + j] = from_f<S>(o[i][2]);
        gh_row[j] = sr;
        gh_row[H + j] = sz;
        gh_row[2 * H + j] = from_f<S>(o[i][3]);
      }
    }
    if (t > 0) load_in(t - 1);
    if (push) {
      // this parity's phase of step t is the ((T - 1 - t) / 2)-th
      mbar_wait(mb, (uint32_t)(((T - 1 - t) >> 1) & 1));
    } else {
      cluster_wait();
    }
    // dh of the own units: the peers' partials summed in rank order
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int q = tid + i * THREADS, b = q / U, u = q - b * U;
      if (push && b < nb && u < nu) {
        float v[MAX_CLUSTER];  // every load in flight, then summed
#pragma unroll
        for (int jr = 0; jr < (int)MAX_CLUSTER; ++jr)
          v[jr] = jr < C ? xbuf[((size_t)jr * R + b) * U + u] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int jr = 0; jr < (int)MAX_CLUSTER; ++jr) s += v[jr];
        dh[i] = dtz[i] + s;
      } else if (b < nb && u < nu) {
        const size_t o = (size_t)b * H + u0 + u;
        float v[MAX_CLUSTER];  // every load in flight, then summed
#pragma unroll
        for (int jr = 0; jr < (int)MAX_CLUSTER; ++jr)
          v[jr] = jr < C ? cluster.map_shared_rank(xbuf, (unsigned)jr)[o] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int jr = 0; jr < (int)MAX_CLUSTER; ++jr) s += v[jr];
        dh[i] = dtz[i] + s;
      }
    }
    // push: the next gate step rewrites the slice tile this step's product
    // read (pull: the cluster barrier ordered them)
    if (push) __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PMAX; ++i) {
    const int q = tid + i * THREADS, b = q / U, u = q - b * U;
    if (b < nb && u < nu) a.dh0[(size_t)(b0 + b) * H + u0 + u] = dh[i];
  }
  // no block leaves while a peer may still read its buffers
  cluster.sync();
}

typedef void (*FwdFn)(GruResFwdArgs, GruResPlan);
typedef void (*BwdFn)(GruResBwdArgs, GruResPlan);

template <typename S>
FwdFn fwd_fn(int64_t rb) {
  switch (rb) {
    case 1: return gru_res_fwd<S, 1>;
    case 2: return gru_res_fwd<S, 2>;
    case 3: return gru_res_fwd<S, 3>;
    case 4: return gru_res_fwd<S, 4>;
    case 5: return gru_res_fwd<S, 5>;
    case 6: return gru_res_fwd<S, 6>;
    case 7: return gru_res_fwd<S, 7>;
    default: return gru_res_fwd<S, 8>;
  }
}
template <typename S, int NO>
BwdFn bwd_fn_no(int64_t rb) {
  switch (rb) {
    case 1: return gru_res_bwd<S, 1, NO>;
    case 2: return gru_res_bwd<S, 2, NO>;
    case 3: return gru_res_bwd<S, 3, NO>;
    case 4: return gru_res_bwd<S, 4, NO>;
    case 5: return gru_res_bwd<S, 5, NO>;
    case 6: return gru_res_bwd<S, 6, NO>;
    case 7: return gru_res_bwd<S, 7, NO>;
    default: return gru_res_bwd<S, 8, NO>;
  }
}
template <typename S>
BwdFn bwd_fn(int64_t rb, int64_t no) {
  return no == 2 ? bwd_fn_no<S, 2>(rb) : bwd_fn_no<S, 1>(rb);
}
const void* entry(bool bf16, bool backward, int64_t rb, int64_t no) {
  if (backward)
    return bf16 ? (const void*)bwd_fn<__nv_bfloat16>(rb, no) : (const void*)bwd_fn<float>(rb, no);
  return bf16 ? (const void*)fwd_fn<__nv_bfloat16>(rb) : (const void*)fwd_fn<float>(rb);
}

cudaError_t set_attrs(const void* fn, int64_t smem, int64_t cluster) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              cluster > 8 ? 1 : 0);
}

cudaLaunchConfig_t config(int64_t blocks, int64_t smem, int64_t cluster, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What the card grants, per device, type and direction: the largest
// cluster and, for each cluster size 2^i, the clusters it holds at once
// with one block an SM (queried once).
struct CardLimits {
  bool known;
  int sms, max_cluster;
  int active[5];
};
CardLimits g_limits[16][2][2];

cudaError_t card_limits(bool bf16, bool backward, CardLimits** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  CardLimits* L = &g_limits[dev & 15][bf16][backward];
  if (!L->known) {
    e = cudaDeviceGetAttribute(&L->sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const void* fn = entry(bf16, backward, MAX_RB, 1);
    e = set_attrs(fn, SMEM_BUDGET, MAX_CLUSTER);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(MAX_CLUSTER, SMEM_BUDGET, MAX_CLUSTER, 0, attr);
    cfg.numAttrs = 0;
    int mc = 0;
    e = cudaOccupancyMaxPotentialClusterSize(&mc, fn, &cfg);
    if (e != cudaSuccess) return e;
    L->max_cluster = mc < 1 ? 1 : (mc > MAX_CLUSTER ? (int)MAX_CLUSTER : mc);
    for (int i = 0; i < 5; ++i) {
      const int c = 1 << i;
      L->active[i] = 0;
      if (c > L->max_cluster) continue;
      cfg = config(c, SMEM_BUDGET, c, 0, attr);
      int n = 0;
      e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
      if (e != cudaSuccess) return e;
      L->active[i] = n;
    }
    // the largest size of 2^i the card holds at least one cluster of
    int best = 1;
    for (int i = 0; i < 5; ++i)
      if ((1 << i) <= L->max_cluster && L->active[i] > 0) best = 1 << i;
    L->max_cluster = best;
    L->known = true;
  }
  *out = L;
  return cudaSuccess;
}

int log2_of(int64_t c) {
  int i = 0;
  while ((int64_t(1) << (i + 1)) <= c) ++i;
  return i;
}

// The plan on this card.
cudaError_t card_plan(int64_t B, int64_t H, bool bf16, bool backward, GruResPlan* p) {
  CardLimits* L = nullptr;
  cudaError_t e = card_limits(bf16, backward, &L);
  if (e != cudaSuccess) return e;
  GruResPlan q;
  if (!res_plan(B, H, backward, L->sms, L->max_cluster, 0, &q)) return cudaErrorInvalidValue;
  // again with the clusters of that size the card holds at once
  const int64_t act = L->active[log2_of(q.cluster)];
  if (!res_plan(B, H, backward, L->sms, L->max_cluster, act, p)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan as pure arithmetic, for the given card figures (the Python
// mirror's check): out = the GruResPlan fields in order. 0, or 1 when no
// plan exists.
int wr_gru_res_plan(int64_t B, int64_t H, int64_t backward, int64_t sms, int64_t max_cluster,
                    int64_t active, int64_t* out) {
  GruResPlan p;
  if (!res_plan(B, H, backward != 0, sms, max_cluster, active, &p)) return 1;
  *reinterpret_cast<GruResPlan*>(out) = p;
  return 0;
}

// The plan this card gets, and what it grants: out = the GruResPlan fields,
// then sms, the largest cluster and the clusters of the plan's size it
// holds at once. Returns the CUDA error code.
int wr_gru_res_card_plan(int64_t B, int64_t H, int64_t bf16, int64_t backward, int64_t* out) {
  GruResPlan p;
  cudaError_t e = card_plan(B, H, bf16 != 0, backward != 0, &p);
  if (e != cudaSuccess) return e;
  *reinterpret_cast<GruResPlan*>(out) = p;
  CardLimits* L = nullptr;
  card_limits(bf16 != 0, backward != 0, &L);
  constexpr int n = sizeof(GruResPlan) / sizeof(int64_t);
  out[n] = L->sms;
  out[n + 1] = L->max_cluster;
  out[n + 2] = L->active[log2_of(p.cluster)];
  return 0;
}

// Forward over all T steps on `stream`; returns the CUDA error code.
int wr_gru_res_fwd(const GruResFwdArgs* args, void* stream) {
  GruResPlan p;
  const bool bf16 = args->bf16 != 0;
  cudaError_t e = card_plan(args->B, args->H, bf16, false, &p);
  if (e != cudaSuccess) return e;
  const void* fn = entry(bf16, false, p.rb, p.no);
  e = set_attrs(fn, p.smem, p.cluster);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(p.cluster * p.clusters, p.smem, p.cluster, (cudaStream_t)stream, attr);
  GruResFwdArgs a = *args;
  void* kargs[] = {&a, &p};
  e = cudaLaunchKernelExC(&cfg, fn, kargs);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Backward over all T steps, in reverse, on `stream`; returns the CUDA
// error code. args->dh0 receives dh0 (dh_T is zero).
int wr_gru_res_bwd(const GruResBwdArgs* args, void* stream) {
  GruResPlan p;
  const bool bf16 = args->bf16 != 0;
  cudaError_t e = card_plan(args->B, args->H, bf16, true, &p);
  if (e != cudaSuccess) return e;
  const void* fn = entry(bf16, true, p.rb, p.no);
  e = set_attrs(fn, p.smem, p.cluster);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(p.cluster * p.clusters, p.smem, p.cluster, (cudaStream_t)stream, attr);
  GruResBwdArgs a = *args;
  void* kargs[] = {&a, &p};
  e = cudaLaunchKernelExC(&cfg, fn, kargs);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
