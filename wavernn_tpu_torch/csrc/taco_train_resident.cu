// Tacotron attention-forcing decoder recurrence (B7) for Hopper (sm_90a),
// redesigned around the card: taco_af_res_fwd / taco_af_res_bwd, one
// cooperative launch per direction, one block per SM, 256 threads. Every AF
// training path runs here; csrc/taco_train.cu's AF arm (taco_af_fwd /
// taco_af_bwd) is the yardstick, reached only through the wrappers' private
// _legacy=True.
//
// Replaces: wavernn_tpu/ops/pallas_taco_train.py, _make_fwd_kernel(af=True)
// (:80, called at :328 through _fwd_impl, via _core_af :802) and
// _make_bwd_kernel(af=True) (:350, called at :925 through _core_af_bwd
// :836). ops/cuda_taco_train.py holds the wrappers, the launch plan
// (af_resident_plan) and the plain versions (core_af_ref, core_af_bwd_ref).
//
// What it computes is taco_train.cu's AF arm (its head note has the
// equations), with the same inputs, outputs and saved streams (AF_STREAMS,
// the s_* fields of TfFwdArgs / AfFwdArgs): a forward of either body feeds
// a backward of either. This file includes taco_train.cu and reuses its
// argument structs, its device helpers (dots, lsa_args, lsa_u,
// loc_input_grad, ...) and its weight-gradient reductions (wgrad_gemm,
// colsum, reduce_parts) unchanged.
//
// What bounds it. At B 32, T_text 150, 200 groups (r 2) the forward is 97.4
// GFLOP (1.45 ms at 67 TF/s float32), the backward 224.7 GFLOP (3.35 ms);
// neither is near: the limit is the chain of 200 dependent groups, each a
// chain of stages that need the previous stage's whole output. The
// original body's per-stage split (tools/probe_b7_split.py; PERF.md
// section 6) put 47 % of a forward group and 67 % of a backward group in
// the attention stage, run on one block per utterance (32 of 132
// SMs), and most of the rest in matrix stages that staged their rows one
// L2 round trip at a time and re-read every weight row from L2 for each
// pass of 8 batch rows, on half the warps.
//
// Design, against that:
//  1. The context leaves the recurrence. In AF the context weights are the
//     reference attention, an input, so ctx_g = sum_t aref[g, b, t] enc_t
//     for every group is one product formed before the first group (in
//     weighted_rows' order, so bit for bit the original's); in the
//     backward d(aref) = dctx . enc_t and d(enc) += aref dctx feed nothing
//     in the recurrence and are formed after the last group from the saved
//     dctx of every group. The attention (query, location conv, energies,
//     normaliser) then feeds only the next group's attention and the
//     outputs: a side chain beside the mel chain
//     GRU -> query | rnn_input -> LSTM1 -> LSTM2 -> mel -> prenet -> GRU.
//  2. The attention runs on every block, off the mel chain, in items of 16
//     text positions of one utterance (B * ceil(T / 16) items, item i on
//     block i mod grid): each the original's chunk code, so the energies
//     are the original's sums; the normaliser summed from the items'
//     partials in a fixed order; the location conv's input cotangents
//     (a 16 x D by D x 62 product per item, then the window's sums) handed
//     to the neighbouring items. A block runs its items between its arrival
//     at a stage's barrier and its wait there, so they fill the barrier's
//     latency. In the backward the attention chain (d(scores) ->
//     normaliser -> energies -> conv) needs none of the mel chain's
//     cotangents in AF, so it runs a group ahead and hands the mel chain
//     d(query) through c_dq.
//  3. Matrix stages. Unit j of every stage belongs to block j mod grid (as
//     in the original). The LSTMs' rows of a block's units sit in shared
//     memory for the whole forward, copied once by cp.async.bulk on an
//     mbarrier, where the plan has room (LSTM1, then LSTM2: 128 KB a block
//     at L 512 on 132 SMs); the other stages stream theirs from L2, a few
//     k-steps' rows loaded ahead of their FMAs. A stage's inputs, up to 32
//     batch rows (four tiles of 8), are staged a chunk of columns at a time
//     by cp.async, every copy of a chunk in flight; the block's (unit,
//     tile) items go to all eight warps. A unit's dot products keep the
//     original's order over the chunks (lanes along the reduction, the same
//     xor butterfly), so the mel chain's outputs are bit for bit the
//     original's.
//  4. The prenet is two unit stages (its 368 KB of weights do not fit one
//     block per utterance, where the original read them from L2 every
//     group), and its previous frame comes from the mel stage.
//  5. Barriers. Every stage of the mel chain needs every block's output of
//     the stage before, and every block owns units of every stage, so a
//     reader would wait on every writer: the barrier stays, as a split
//     counter barrier (an arrive that releases, a wait that acquires)
//     with the attention items between the two. A piece run between
//     arrive(k) and wait(k) is seen by every block from interval k + 2 on,
//     and what it reads is not overwritten before then; the schedule in
//     the source keeps to that.
// Not used: tensor cores (float32 throughout, no TF32: the gradients are
// held to 1e-4), clusters, tagged words, a second chunk buffer (measured
// slower: the copies are bound by every SM reading the same lines from L2).
#include "taco_train.cu"

namespace res {

typedef unsigned long long u64;
constexpr int WIN = TC + 2 * CONV_HALF;  // an item's window of positions (46)
constexpr int WINP = 48;
constexpr unsigned SPIN_LIMIT = 1u << 24;  // polls before a lost block traps

}  // namespace res

// The launch plan, computed by ops/cuda_taco_train.py (af_resident_plan)
// and mirrored there field for field: 8-byte fields only. Offsets are in
// floats into the dynamic shared memory (the weights' mbarrier sits at 0).
struct ResPlan {
  int64_t nblk;        // grid: one block per SM
  int64_t tp;          // tiles of 8 batch rows a staged pass holds (<= 4)
  int64_t kc;          // columns of a staged chunk
  int64_t smem_bytes;
  int64_t off_w01t;    // (62, D) location weight
  int64_t off_att;     // attention scratch
  int64_t off_x;       // staged chunk: 8 tp rows x kc columns
  int64_t off_l1;      // forward: resident LSTM1 rows (res_l1)
  int64_t off_l2;      // forward: resident LSTM2 rows (res_l2)
  int64_t off_gw;      // backward: the block's location-weight gradient
  int64_t off_pv;      // backward: the block's v gradient
  int64_t res_l1, res_l2;
  int64_t upb_l;       // LSTM units a block owns at most
  int64_t nc;          // attention items per utterance: ceil(T / 16)
  int64_t ipb;         // attention items a block owns at most
  int64_t gw_global;   // backward: the gradient in the block's slice of pw01
  int64_t ctx_smem;    // forward: the context product reads enc from smem
  int64_t epi_tt;      // backward epilogue: positions a task
  int64_t epi_gc;      // backward epilogue: groups a chunk in smem
};

namespace res {

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Split barrier over the grid: arrive() after a block's own stage work,
// wait() before the next stage reads. A monotonic counter: epoch e is
// complete when it reaches e * nblk.
struct Bar {
  u64* ctr;
  u64 n, epoch;
  __device__ __forceinline__ void arrive() {
    __syncthreads();
    ++epoch;
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(ctr, 1ull);
    }
  }
  __device__ __forceinline__ void wait() {
    if (threadIdx.x == 0) {
      unsigned spins = 0;
      while (ld_acquire(ctr) < epoch * n)
        if (++spins > SPIN_LIMIT) __trap();
      __threadfence();
    }
    __syncthreads();
  }
  __device__ __forceinline__ void sync() {
    arrive();
    wait();
  }
};

// ---- the weights' one-time bulk copy (as sample_loop_resident.cu) ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* mb, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(mb)), "r"(count)
               : "memory");
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
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(mb)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(mb))
      : "memory");
}

// Columns [c0, c1) of rows [r0, r0 + nr) of the segments side by side into
// X (row stride kcs), by 16-byte cp.async copies through L2 (other blocks
// wrote them in this launch), every copy of the chunk in flight at once,
// committed as one group; a segment with no pointer stages zeros. All
// threads; the caller waits for the group and synchronises.
__device__ __forceinline__ void stage_chunk(float* X, int kcs, int r0, int nr, const Seg* segs,
                                            int nseg, int c0, int c1) {
  const int w4 = (c1 - c0) >> 2, tot = nr * w4;
  for (int e = threadIdx.x; e < tot; e += THREADS) {
    const int b = e / w4, k = e - b * w4, col = c0 + 4 * k;
    // the segment of column col (at most three, unrolled: no indexed
    // array of segments in local memory)
    const float* src = nullptr;
    int off = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s < nseg && col >= off && col < off + segs[s].w && segs[s].p)
        src = segs[s].p + (size_t)(r0 + b) * segs[s].ld + col - off;
      if (s < nseg) off += segs[s].w;
    }
    float* dst = X + (size_t)b * kcs + 4 * k;
    if (src)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(res::smem_u32(dst)),
                   "l"(src)
                   : "memory");
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// dots() over one staged chunk: acc[g][i] += sum_k w[g * gs + k] X[i, xoff +
// k] for the lane's k = lane * 4 + 128 i < n whose column xoff + k lies in
// [c0, c1) (X holds columns c0.. with row stride kcs). Over the chunks in
// order every sum meets its terms in dots()'s order. SM: the rows are in
// shared memory.
template <int NG, bool SM, typename W>
__device__ __forceinline__ void kdots(float (&acc)[NG][RB], const W* __restrict__ w, size_t gs,
                                      int n, int xoff, const float* X, int kcs, int c0, int c1,
                                      int nr) {
  // rows in device memory: KS k-steps' weights loaded before their FMAs,
  // so KS * NG loads are in flight
  constexpr int KS = SM ? 1 : (NG <= 2 ? 4 : 2);
  int k = (threadIdx.x & 31) * 4;
  if (xoff + k < c0) k += (c0 - xoff - k + 127) / 128 * 128;
  const int kend = min(n, c1 - xoff);
  for (; k < kend; k += 128 * KS) {
    typename Raw4<W>::type wv[KS][NG];
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int ks = k + 128 * s;
        wv[s][g] = ks >= kend ? zero4<W>()
                   : SM       ? raw4(w + g * gs + ks)
                              : rawg4(w + g * gs + ks);
      }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int ks = k + 128 * s;
      if (ks >= kend) break;
      const int col = xoff + ks - c0;
      float4 xv[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        xv[i] = i < nr ? *reinterpret_cast<const float4*>(X + (size_t)i * kcs + col)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 wf = wide4(wv[s][g]);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          acc[g][i] = fmaf(wf.x, xv[i].x, acc[g][i]);
          acc[g][i] = fmaf(wf.y, xv[i].y, acc[g][i]);
          acc[g][i] = fmaf(wf.z, xv[i].z, acc[g][i]);
          acc[g][i] = fmaf(wf.w, xv[i].w, acc[g][i]);
        }
      }
    }
  }
}

// NV sums at once (NV = 8 or 32): value q of every lane ends, summed over
// the warp, on lanes q * 32 / NV .. (q + 1) * 32 / NV - 1; every sum's
// pairs are the xor butterfly's, so its bits are warp_sum's
// (sample_loop_resident.cu's reduce_scatter).
template <int N>
__device__ __forceinline__ void halve(float* v, int o, bool upper) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const float send = upper ? v[q] : v[q + N / 2];
    const float keep = upper ? v[q + N / 2] : v[q];
    v[q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}
__device__ __forceinline__ float reduce_scatter8(float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  halve<8>(v, 16, lane & 16);
  halve<4>(v, 8, lane & 8);
  halve<2>(v, 4, lane & 4);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return v[0];
}
__device__ __forceinline__ float reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  halve<32>(v, 16, lane & 16);
  halve<16>(v, 8, lane & 8);
  halve<8>(v, 4, lane & 4);
  halve<4>(v, 2, lane & 2);
  halve<2>(v, 1, lane & 1);
  return v[0];
}

// reduce(): acc[g][i] summed over the warp, for pick(acc[g], i) on lane i
// (< 8). NG 1 and 4 by reduce_scatter (11 or 31 shuffles, not 40 NG, and
// the same bits), every acc[g][.] then holding lane i's sum.
template <int NG>
__device__ __forceinline__ void reduce_rows(float (&acc)[NG][RB]) {
  if constexpr (NG == 1 || NG == 4) {
    constexpr int NV = NG * RB;
    float v[NV];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < RB; ++i) v[g * RB + i] = acc[g][i];
    float r;
    if constexpr (NV == 32)
      r = reduce_scatter32(v);
    else
      r = reduce_scatter8(v);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float sum = __shfl_sync(0xffffffffu, r, (g * RB + (lane & 7)) * (32 / NV));
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[g][i] = sum;
    }
  } else {
    reduce(acc);
  }
}

// A stage over `units` output units. Block k owns units k, k + grid, ...;
// a pass holds up to 4 tiles of 8 batch rows, and its items (unit, tile)
// go to the warps, IPW at a time a warp, each with NA sets of NG x 8 sums
// in registers. The pass's rows are staged a chunk of columns at a time,
// every warp runs dots(acc, j, m, X of its tile, kcs, c0, c1, rows) on its
// items, and after the last chunk the sums are reduced (the xor
// butterfly's pairs) and epi(acc, j, m, first row, rows) runs.
template <int NG, int NA, int IPW, typename Dots, typename Epi>
__device__ __forceinline__ void kstage(const ResPlan& p, float* X, int B, int units, const Seg* segs, int nseg,
                       Dots&& dots, Epi&& epi) {
  const int nblk = (int)p.nblk, tp = (int)p.tp, kc = (int)p.kc;
  if ((int)blockIdx.x >= units) return;  // block-uniform
  const int mine = (units - 1 - (int)blockIdx.x) / nblk + 1;
  int xs = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s)
    if (s < nseg) xs += segs[s].w;
  const int warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < B; r0 += 8 * tp) {
    const int nrp = min(8 * tp, B - r0), nitems = mine * ((nrp + 7) / 8);
    for (int ib = 0; ib < nitems; ib += WARPS * IPW) {
      float acc[IPW][NA][NG][RB];
#pragma unroll
      for (int q = 0; q < IPW; ++q)
#pragma unroll
        for (int a = 0; a < NA; ++a) zero(acc[q][a]);
      for (int c0 = 0; c0 < xs; c0 += kc) {
        const int c1 = min(c0 + kc, xs);
        __syncthreads();   // every warp is done with the previous chunk
        stage_chunk(X, kc, r0, nrp, segs, nseg, c0, c1);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();   // the chunk has landed for every thread
#pragma unroll
        for (int q = 0; q < IPW; ++q) {
          const int it = ib + warp + WARPS * q;
          if (it < nitems) {
            const int tile = it / mine, m = it - tile * mine;
            dots(acc[q], (int)blockIdx.x + m * nblk, m, X + (size_t)tile * 8 * kc, kc, c0, c1,
                 min(8, nrp - tile * 8));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < IPW; ++q) {
        const int it = ib + warp + WARPS * q;
        if (it < nitems) {
          const int tile = it / mine, m = it - tile * mine;
#pragma unroll
          for (int a = 0; a < NA; ++a) reduce_rows(acc[q][a]);
          epi(acc[q], (int)blockIdx.x + m * nblk, m, r0 + tile * 8, min(8, nrp - tile * 8));
        }
      }
    }
  }
}

// per-stage cycle split (the profiling instantiation, block 0, thread 0)
struct Prof {
  long long* out;
  long long last;
  __device__ __forceinline__ void start(long long* o) {
    out = o;
    if (out && blockIdx.x == 0 && threadIdx.x == 0) last = clock64();
  }
  __device__ __forceinline__ void stamp(int i) {
    if (out && blockIdx.x == 0 && threadIdx.x == 0) {
      const long long now = clock64();
      out[i] += now - last;
      last = now;
    }
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// One of a pair of buffers, chosen without indexing the pair by a run-time
// value (that would put the whole work struct in local memory).
__device__ __forceinline__ float* pair_at(float* const (&p)[2], int i) { return i ? p[1] : p[0]; }

template <typename S>
struct FWork {
  float *ah[2], *h1[2], *c1[2], *h2[2], *c2[2], *x0, *x1, *x2, *q[2];
  float *cumb[2], *sigb[2], *divp[2], *ctx;
  u64* bar;
  // bf16: float copies of the streams the stages stage (every group's
  // context, the prenet's previous frame, its first layer and its output)
  float *ctxf = nullptr, *prevf = nullptr, *p1f = nullptr, *pref = nullptr;
  int64_t size;
  __host__ __device__ FWork(float* w, const TfFwdArgs& a, const ResPlan& p,
                            const AfFwdArgs* x = nullptr) {
    Take take{w};
    const int64_t B = a.B;
    for (int i = 0; i < 2; ++i) {
      ah[i] = take(B * a.D);
      h1[i] = take(B * a.L); c1[i] = take(B * a.L);
      h2[i] = take(B * a.L); c2[i] = take(B * a.L);
      q[i] = take(B * a.D);
      cumb[i] = take(B * a.T); sigb[i] = take(B * a.T);
      divp[i] = take(B * p.nc);
    }
    x0 = take(B * a.L); x1 = take(B * a.L); x2 = take(B * a.L);
    ctx = a.save ? nullptr : take(a.G * B * a.E);
    bar = reinterpret_cast<u64*>(take(4));
    if (!std::is_same<S, float>::value && x) {
      ctxf = take(a.G * B * a.E);
      prevf = take(a.G * B * x->NM);
      p1f = take(a.G * B * x->P1);
      pref = take(a.G * B * a.P2);
    }
    size = take.size;
  }
};

// ctx[g, b] = sum_t aref[g, b, t] enc[b, t] for every group, in
// weighted_rows' order: float4 column c of a chunk of cols = min(E4 - c0,
// 256) columns has ns = 256 / cols slices, slice s sums t = s, s + ns, ...
// by fmaf, and the slices are added in order. Block k takes a contiguous
// run of (b, g) pairs, b major, and stages enc[b] in shared memory when the
// plan has room.
__device__ __forceinline__ void ctx_product(const TfFwdArgs& a, const AfFwdArgs& x, const ResPlan& p, float* ctx,
                            float* sm) {
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T, E = (int)a.E, E4 = E / 4;
  const int pairs = G * B, nblk = (int)p.nblk;
  const int per = (pairs + nblk - 1) / nblk;
  const int lo = min(pairs, (int)blockIdx.x * per), hi = min(pairs, lo + per);
  int bcur = -1;
  for (int q0 = lo; q0 < hi;) {
    const int b = q0 / G;
    const int qe = min(hi, (b + 1) * G);   // pairs of this utterance
    const float4* src = reinterpret_cast<const float4*>(a.enc + (size_t)b * T * E);
    if (p.ctx_smem && b != bcur) {
      __syncthreads();
      for (int e = threadIdx.x; e < T * E4; e += THREADS)
        reinterpret_cast<float4*>(sm)[e] = __ldg(src + e);
      __syncthreads();
      bcur = b;
    }
    const float4* en = p.ctx_smem ? reinterpret_cast<const float4*>(sm) : src;
    const int outs = (qe - q0) * E4;
    for (int o = threadIdx.x; o < outs; o += THREADS) {
      const int g = q0 - b * G + o / E4, c = o % E4;
      const int c0 = c / THREADS * THREADS, cols = min(E4 - c0, THREADS), ns = THREADS / cols;
      const float* ar = x.aref + ((size_t)g * B + b) * T;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sl = 0; sl < ns; ++sl) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t = sl; t < T; t += ns) {
          const float st = __ldg(ar + t);
          const float4 v = en[(size_t)t * E4 + c];
          acc.x = fmaf(st, v.x, acc.x);
          acc.y = fmaf(st, v.y, acc.y);
          acc.z = fmaf(st, v.z, acc.z);
          acc.w = fmaf(st, v.w, acc.w);
        }
        if (sl == 0) {
          sum = acc;
        } else {
          sum.x += acc.x;
          sum.y += acc.y;
          sum.z += acc.z;
          sum.w += acc.w;
        }
      }
      reinterpret_cast<float4*>(ctx + ((size_t)g * B + b) * E)[c] = sum;
    }
    q0 = qe;
  }
  __syncthreads();
}

// ctx_product with bf16 enc and aref: the same sums (enc staged in shared
// memory as floats when the plan has room), each rounded to bf16 into the
// ctx stream and, as floats, into ctxf (the stages' copy).
__device__ __forceinline__ void ctx_product_bf16(const TfFwdArgs& a, const AfFwdArgs& x,
                                                 const ResPlan& p, bf16_t* ctx, float* ctxf,
                                                 float* sm) {
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T, E = (int)a.E, E4 = E / 4;
  const int pairs = G * B, nblk = (int)p.nblk;
  const int per = (pairs + nblk - 1) / nblk;
  const int lo = min(pairs, (int)blockIdx.x * per), hi = min(pairs, lo + per);
  const bf16_t* aref = cs<bf16_t>(x.aref);
  int bcur = -1;
  for (int q0 = lo; q0 < hi;) {
    const int b = q0 / G;
    const int qe = min(hi, (b + 1) * G);
    const bf16_t* src = cs<bf16_t>(a.enc) + (size_t)b * T * E;
    if (p.ctx_smem && b != bcur) {
      __syncthreads();
      for (int e = threadIdx.x; e < T * E4; e += THREADS)
        reinterpret_cast<float4*>(sm)[e] = ldg4(src + 4 * (size_t)e);
      __syncthreads();
      bcur = b;
    }
    const int outs = (qe - q0) * E4;
    for (int o = threadIdx.x; o < outs; o += THREADS) {
      const int g = q0 - b * G + o / E4, c = o % E4;
      const int c0 = c / THREADS * THREADS, cols = min(E4 - c0, THREADS), ns = THREADS / cols;
      const bf16_t* ar = aref + ((size_t)g * B + b) * T;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sl = 0; sl < ns; ++sl) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t = sl; t < T; t += ns) {
          const float st = ldgv(ar + t);
          const size_t i4 = (size_t)t * E4 + c;
          const float4 v = p.ctx_smem ? reinterpret_cast<const float4*>(sm)[i4] : ldg4(src + 4 * i4);
          acc.x = fmaf(st, v.x, acc.x);
          acc.y = fmaf(st, v.y, acc.y);
          acc.z = fmaf(st, v.z, acc.z);
          acc.w = fmaf(st, v.w, acc.w);
        }
        if (sl == 0) {
          sum = acc;
        } else {
          sum.x += acc.x;
          sum.y += acc.y;
          sum.z += acc.z;
          sum.w += acc.w;
        }
      }
      sum = rnd4<bf16_t>(sum);
      const size_t off = ((size_t)g * B + b) * E + 4 * (size_t)c;
      st4(ctx + off, sum);
      st4(ctxf + off, sum);
    }
    q0 = qe;
  }
  __syncthreads();
}

// sum_k src[k] for k < n in order, every load in flight at once (all
// threads; part: n floats of scratch). Thread 0 holds the sum.
__device__ __forceinline__ float ordered_sum(const float* src, int n, float* part) {
  for (int k = threadIdx.x; k < n; k += THREADS) part[k] = __ldcg(src + k);
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < n; ++k) s += part[k];
  return s;
}

// One forward attention item: positions [16c, 16c + tc) of utterance b at
// group g. The normaliser of group g - 1 from its items' partials, the
// item's window of the cumulative and previous attention, the scores of
// group g - 1 and the cumulative entering g at its own positions, then the
// original's chunk code for the energies; the unnormalised sigmoids and
// their partial sum go to the next group's items.
template <typename S>
__device__ __forceinline__ void att_fwd_item(const TfFwdArgs& a, const FWork<S>& w, const S* s_w01t, float* sc,
                             int nc, int b, int c, int g) {
  const int B = (int)a.B, T = (int)a.T, D = (int)a.D;
  const int t0 = c * TC, tc = min(TC, T - t0);
  const bool save = a.save != 0;
  float* cw = sc;
  float* aw = cw + res::WINP;
  float* red16 = aw + res::WINP;
  float* su = red16 + WARPS * TC;
  float* misc = su + TC;
  float* part = misc + 16;
  const int pg = (g + 1) & 1, cg_ = g & 1;
  __syncthreads();
  const float dsum = ordered_sum(pair_at(w.divp, pg) + (size_t)b * nc, g > 0 ? nc : 0, part);
  if (threadIdx.x == 0) misc[0] = dsum;
  __syncthreads();
  const float div = misc[0], dv = div > 0.f ? div : 1.f;
  if (threadIdx.x < res::WINP) {
    const int j = threadIdx.x, t = t0 - CONV_HALF + j;
    const bool in = j < res::WIN && t >= 0 && t < T;
    float at = 0.f, cu = 0.f;
    if (g > 0 && in) {
      at = rnd<S>(__ldcg(pair_at(w.sigb, pg) + (size_t)b * T + t) / dv);
      cu = __ldcg(pair_at(w.cumb, pg) + (size_t)b * T + t) + at;
    }
    cw[j] = cu;
    aw[j] = at;
    if (j >= CONV_HALF && j < CONV_HALF + tc) {
      pair_at(w.cumb, cg_)[(size_t)b * T + t] = cu;
      if (save) a.s_cum[((size_t)g * B + b) * T + t] = cu;
      if (g > 0) a.scores[((size_t)(g - 1) * B + b) * T + t] = at;
    }
  }
  if (c == 0 && threadIdx.x == 0 && g > 0 && save) a.s_div[(size_t)(g - 1) * B + b] = div;
  __syncthreads();
  const int d = threadIdx.x;
  const bool unit = d < D;
  const float qd = unit ? __ldcg(pair_at(w.q, cg_) + (size_t)b * D + d) : 0.f;
  const float vd = unit ? ldv(cs<S>(a.v) + d) : 0.f;
  float arg[TC];
  if (unit) {
    lsa_args(arg, 0, tc, d, D, qd, cw, aw, s_w01t, cs<S>(a.encp) + ((size_t)b * T + t0) * D);
  } else {
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) arg[tt] = 0.f;
  }
  lsa_u(arg, vd, red16, su);
  if (threadIdx.x < tc) {
    const float sig = sigm(su[threadIdx.x]);
    pair_at(w.sigb, cg_)[(size_t)b * T + t0 + threadIdx.x] = sig;
    su[threadIdx.x] = sig;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int tt = 0; tt < tc; ++tt) s += su[tt];
    pair_at(w.divp, cg_)[(size_t)b * nc + c] = s;
  }
}

// The last group's scores and normaliser (nothing reads them in the loop).
template <typename S>
__device__ __forceinline__ void att_fwd_last(const TfFwdArgs& a, const FWork<S>& w, float* sc, int nc, int b, int c) {
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T;
  const int t0 = c * TC, tc = min(TC, T - t0), lg = (G - 1) & 1;
  __syncthreads();
  const float dsum = ordered_sum(pair_at(w.divp, lg) + (size_t)b * nc, nc, sc + 16);
  if (threadIdx.x == 0) sc[0] = dsum;
  __syncthreads();
  const float div = sc[0], dv = div > 0.f ? div : 1.f;
  if (threadIdx.x < tc) {
    const int t = t0 + threadIdx.x;
    a.scores[((size_t)(G - 1) * B + b) * T + t] =
        rnd<S>(__ldcg(pair_at(w.sigb, lg) + (size_t)b * T + t) / dv);
  }
  if (c == 0 && threadIdx.x == 0 && a.save) a.s_div[(size_t)(G - 1) * B + b] = div;
}

// forward profile labels (cycles summed over groups, block 0)
enum FProf {
  FP_PRO, FP_GRU, FP_GRU_W, FP_QC, FP_QC_W, FP_L1, FP_L1_ATT, FP_L1_W, FP_L2, FP_L2_ATT, FP_L2_W,
  FP_MEL, FP_MEL_ATT, FP_MEL_W, FP_P1, FP_P1_ATT, FP_P1_W, FP_P2, FP_P2_ATT, FP_P2_W, FP_EPI
};

// S: the storage type of the weights, the streams, the saved states and the
// mel (float, or bf16 in taco_af_res_*_bf16); the stages stage floats (bf16
// streams they read have float copies in FWork), and the values the JAX
// kernel rounds to its compute dtype are rounded by rnd<S> where they are
// formed (ah, ctx, x0, c, h, x1, x2, the mel, p1, the prenet's output, the
// scores).
template <bool PROF, typename S>
__device__ __forceinline__ void fwd_res(const TfFwdArgs& a, const AfFwdArgs& x, const ResPlan& p,
                                        long long* prof_out) {
  constexpr bool BF = !std::is_same<S, float>::value;
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T, E = (int)a.E, D = (int)a.D;
  const int P2 = (int)a.P2, L = (int)a.L, F = (int)a.F, P1 = (int)x.P1, NM = (int)x.NM;
  const int nblk = (int)p.nblk, nc = (int)p.nc, ipb = (int)p.ipb;
  const bool save = a.save != 0;
  const int lane = threadIdx.x & 31;
  FWork<S> wk(a.work, a, p, BF ? &x : nullptr);
  Bar bar{wk.bar, (u64)nblk, 0};
  Prof pf;
  pf.start(PROF ? prof_out : nullptr);

  extern __shared__ float smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  S* s_w01t = ms<S>(smem + p.off_w01t);
  float* s_att = smem + p.off_att;
  float* X = smem + p.off_x;
  S* s_l1 = ms<S>(smem + p.off_l1);
  S* s_l2 = ms<S>(smem + p.off_l2);
  S* ctx_all = ms<S>(save ? a.s_ctx : wk.ctx);
  // (the rows the stages stage: the streams, or their float copies in
  // bf16: BF ? wk.ctxf : ctx_all and likewise)

  // ---- prologue: every group's context (smem holds enc[b] meanwhile),
  // then the resident rows, the location weight and the prenet of group 0
  if constexpr (BF)
    ctx_product_bf16(a, x, p, ctx_all, wk.ctxf, smem + 4);
  else
    ctx_product(a, x, p, ctx_all, smem + 4);
  const int mine_l = (int)blockIdx.x < L ? (L - 1 - (int)blockIdx.x) / nblk + 1 : 0;
  const uint32_t row_bytes = (uint32_t)L * (uint32_t)sizeof(S);
  const uint32_t res_bytes =
      (uint32_t)((p.res_l1 + p.res_l2) * mine_l * 8) * row_bytes;  // 4 gates x (wi | wh)
  if (threadIdx.x == 0) {
    mbar_init(mbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && res_bytes) {
    mbar_expect_tx(mbar, res_bytes);
    for (int layer = 0; layer < 2; ++layer) {
      if (!(layer == 0 ? p.res_l1 : p.res_l2)) continue;
      const S* wi = cs<S>(layer == 0 ? a.l1wi : a.l2wi);
      const S* wh = cs<S>(layer == 0 ? a.l1wh : a.l2wh);
      S* dst = layer == 0 ? s_l1 : s_l2;
      for (int m = 0; m < mine_l; ++m) {
        const int j = (int)blockIdx.x + m * nblk;
        for (int g4 = 0; g4 < 4; ++g4) {
          S* row = dst + ((size_t)m * 4 + g4) * 2 * L;
          bulk_g2s(row, wi + ((size_t)g4 * L + j) * L, row_bytes, mbar);
          bulk_g2s(row + L, wh + ((size_t)g4 * L + j) * L, row_bytes, mbar);
        }
      }
    }
  }
  for (int e = threadIdx.x; e < NTAP * D; e += THREADS) s_w01t[e] = cs<S>(a.w01t)[e];
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B * NM; i += nblk * THREADS) {
    stv(ms<S>(x.s_prev) + i, 0.f);   // group 0's prenet reads zeros
    if constexpr (BF) wk.prevf[i] = 0.f;
  }
  if (res_bytes) mbar_wait(mbar, 0);
  __syncthreads();
  bar.sync();

  // the prenet of group gp on the previous frame s_prev[gp]: two stages
  auto prenet1 = [&](int gp) {
    const size_t gb = (size_t)gp * B;
    const Seg segs[1] = {{(BF ? wk.prevf : x.s_prev) + gb * NM, NM, NM}};
    kstage<1, 1, 1>(
        p, X, B, P1, segs, 1,
        [&](float(&acc)[1][1][RB], int k, int, const float* Xt, int kcs, int c0, int c1, int nr) {
          kdots<1, false>(acc[0], cs<S>(x.w1) + (size_t)k * NM, 0, NM, 0, Xt, kcs, c0, c1, nr);
        },
        [&](float(&acc)[1][1][RB], int k, int, int b0, int nr) {
          if (lane < nr) {
            const size_t o = (gb + b0 + lane) * P1 + k;
            const float v =
                rnd<S>(fmaxf(x.b1[k] + pick(acc[0][0], lane), 0.f) * ldv(cs<S>(x.dm1) + o));
            stv(ms<S>(x.s_p1) + o, v);
            if constexpr (BF) wk.p1f[o] = v;
          }
        });
  };
  auto prenet2 = [&](int gp) {
    const size_t gb = (size_t)gp * B;
    const Seg segs[1] = {{(BF ? wk.p1f : x.s_p1) + gb * P1, P1, P1}};
    kstage<1, 1, 1>(
        p, X, B, P2, segs, 1,
        [&](float(&acc)[1][1][RB], int j, int, const float* Xt, int kcs, int c0, int c1, int nr) {
          kdots<1, false>(acc[0], cs<S>(x.w2) + (size_t)j * P1, 0, P1, 0, Xt, kcs, c0, c1, nr);
        },
        [&](float(&acc)[1][1][RB], int j, int, int b0, int nr) {
          if (lane < nr) {
            const size_t o = (gb + b0 + lane) * P2 + j;
            const float v =
                rnd<S>(fmaxf(x.b2[j] + pick(acc[0][0], lane), 0.f) * ldv(cs<S>(x.dm2) + o));
            stv(ms<S>(x.s_pre) + o, v);
            if constexpr (BF) wk.pref[o] = v;
          }
        });
  };
  // this block's attention items of group g in slot s of 5 (the last slot
  // takes what is left)
  auto att_slot = [&](int g, int s) {
    const int m1 = s < 4 ? s + 1 : ipb;
    for (int m = s; m < m1; ++m) {
      const int it = (int)blockIdx.x + m * nblk;
      if (it >= B * nc) break;
      att_fwd_item(a, wk, s_w01t, s_att, nc, it / nc, it % nc, g);
    }
  };
  prenet1(0);
  bar.sync();
  prenet2(0);
  bar.sync();
  pf.stamp(FP_PRO);

  for (int g = 0; g < G; ++g) {
    const size_t gb = (size_t)g * B;
    const int in = (g + 1) & 1, out = g & 1;
    // ---- GRUCell on [ctx_{g-1} | pre_g], h = ah ----
    {
      const Seg segs[3] = {
          {g > 0 ? (BF ? wk.ctxf : reinterpret_cast<float*>(ctx_all)) + (gb - B) * E : nullptr, E,
           E},
          {(BF ? wk.pref : x.s_pre) + gb * P2, P2, P2},
          {pair_at(wk.ah, in), D, D}};
      kstage<3, 2, 1>(
          p, X, B, D, segs, 3,
          [&](float(&acc)[2][3][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            kdots<3, false>(acc[0], cs<S>(a.awi) + (size_t)j * (E + P2), (size_t)D * (E + P2),
                            E + P2, 0, Xt, kcs, c0, c1, nr);
            kdots<3, false>(acc[1], cs<S>(a.awh) + (size_t)j * D, (size_t)D * D, D, E + P2, Xt,
                            kcs, c0, c1, nr);
          },
          [&](float(&acc)[2][3][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float(&gi)[3][RB] = acc[0];
              const float(&gh)[3][RB] = acc[1];
              const float r =
                  sigm((pick(gi[0], lane) + a.abi[j]) + (pick(gh[0], lane) + a.abh[j]));
              const float z =
                  sigm((pick(gi[1], lane) + a.abi[D + j]) + (pick(gh[1], lane) + a.abh[D + j]));
              const float hn = pick(gh[2], lane) + a.abh[2 * D + j];
              const float n = tanhf((pick(gi[2], lane) + a.abi[2 * D + j]) + r * hn);
              const float hp = __ldcg(pair_at(wk.ah, in) + (size_t)b * D + j);
              const float h = rnd<S>((1.f - z) * n + z * hp);
              pair_at(wk.ah, out)[(size_t)b * D + j] = h;
              if (save) {
                stv(ms<S>(a.s_ah) + ((gb + b) * D + j), h);
                S* s = ms<S>(a.s_gru) + (gb + b) * 4 * D;
                stv(s + j, r);
                stv(s + (D + j), z);
                stv(s + (2 * D + j), n);
                stv(s + (3 * D + j), hn);
              }
            }
          });
    }
    pf.stamp(FP_GRU);
    bar.sync();
    pf.stamp(FP_GRU_W);
    // ---- the query q = W ah + b and rnn_input on [ctx_g | ah] ----
    {
      const Seg segs[2] = {{(BF ? wk.ctxf : reinterpret_cast<float*>(ctx_all)) + gb * E, E, E},
                           {pair_at(wk.ah, out), D, D}};
      kstage<1, 1, 3>(
          p, X, B, D + L, segs, 2,
          [&](float(&acc)[1][1][RB], int u, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            if (u < D)
              kdots<1, false>(acc[0], cs<S>(a.wq) + (size_t)u * D, 0, D, E, Xt, kcs, c0, c1, nr);
            else
              kdots<1, false>(acc[0], cs<S>(a.wr) + (size_t)(u - D) * (E + D), 0, E + D, 0, Xt,
                              kcs, c0, c1, nr);
          },
          [&](float(&acc)[1][1][RB], int u, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              if (u < D) {
                const float qv = a.qb[u] + pick(acc[0][0], lane);
                pair_at(wk.q, out)[(size_t)b * D + u] = qv;
                if (save) a.s_q[(gb + b) * D + u] = qv;
              } else {
                const int j = u - D;
                const float x0 = rnd<S>(pick(acc[0][0], lane) + a.br[j]);
                wk.x0[(size_t)b * L + j] = x0;
                if (save) stv(ms<S>(a.s_x0) + ((gb + b) * L + j), x0);
              }
            }
          });
    }
    pf.stamp(FP_QC);
    bar.sync();
    pf.stamp(FP_QC_W);
    // ---- the residual LSTMCells with zoneout on h; each interval's
    // barrier also carries a slot of group g's attention items ----
    for (int layer = 0; layer < 2; ++layer) {
      const S* wi = cs<S>(layer == 0 ? a.l1wi : a.l2wi);
      const S* wh = cs<S>(layer == 0 ? a.l1wh : a.l2wh);
      const S* sw = layer == 0 ? s_l1 : s_l2;
      const bool resident = (layer == 0 ? p.res_l1 : p.res_l2) != 0;
      const float* bias = layer == 0 ? a.l1b : a.l2b;
      const S* zm = cs<S>(layer == 0 ? a.zm1 : a.zm2) + gb * L;
      const float* xin = layer == 0 ? wk.x0 : wk.x1;
      float* xout = layer == 0 ? wk.x1 : wk.x2;
      const float* h_cur = layer == 0 ? pair_at(wk.h1, in) : pair_at(wk.h2, in);
      const float* c_cur = layer == 0 ? pair_at(wk.c1, in) : pair_at(wk.c2, in);
      float* h_nxt = layer == 0 ? pair_at(wk.h1, out) : pair_at(wk.h2, out);
      float* c_nxt = layer == 0 ? pair_at(wk.c1, out) : pair_at(wk.c2, out);
      S* s_gates = ms<S>(layer == 0 ? a.s_g1 : a.s_g2);
      S* s_c = ms<S>(layer == 0 ? a.s_c1 : a.s_c2);
      S* s_h = ms<S>(layer == 0 ? a.s_h1 : a.s_h2);
      S* s_x = ms<S>(layer == 0 ? a.s_x1 : a.s_x2);
      const Seg segs[2] = {{xin, L, L}, {h_cur, L, L}};
      kstage<4, 1, 2>(
          p, X, B, L, segs, 2,
          [&](float(&acc)[1][4][RB], int j, int m, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            if (resident) {
              const S* rows = sw + (size_t)m * 4 * 2 * L;
              kdots<4, true>(acc[0], rows, 2 * (size_t)L, L, 0, Xt, kcs, c0, c1, nr);
              kdots<4, true>(acc[0], rows + L, 2 * (size_t)L, L, L, Xt, kcs, c0, c1, nr);
            } else {
              kdots<4, false>(acc[0], wi + (size_t)j * L, (size_t)L * L, L, 0, Xt, kcs, c0, c1, nr);
              kdots<4, false>(acc[0], wh + (size_t)j * L, (size_t)L * L, L, L, Xt, kcs, c0, c1, nr);
            }
          },
          [&](float(&acc)[1][4][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const size_t o = (size_t)b * L + j;
              const float ig = sigm(pick(acc[0][0], lane) + bias[j]);
              const float fg = sigm(pick(acc[0][1], lane) + bias[L + j]);
              const float gg = tanhf(pick(acc[0][2], lane) + bias[2 * L + j]);
              const float og = sigm(pick(acc[0][3], lane) + bias[3 * L + j]);
              const float c = rnd<S>(fg * __ldcg(c_cur + o) + ig * gg);
              const float hp = __ldcg(h_cur + o);
              const float zz = ldv(zm + o);
              const float h = rnd<S>(zz * hp + (1.f - zz) * (og * tanhf(c)));
              const float xv = rnd<S>(__ldcg(xin + o) + h);
              c_nxt[o] = c;
              h_nxt[o] = h;
              xout[o] = xv;
              if (save) {
                const size_t so = (gb + b) * L + j;
                S* sg = s_gates + (gb + b) * 4 * L;
                stv(sg + j, ig);
                stv(sg + (L + j), fg);
                stv(sg + (2 * L + j), gg);
                stv(sg + (3 * L + j), og);
                stv(s_c + so, c);
                stv(s_h + so, h);
                stv(s_x + so, xv);
              }
            }
          });
      pf.stamp(layer == 0 ? FP_L1 : FP_L2);
      bar.arrive();
      att_slot(g, layer);
      pf.stamp(layer == 0 ? FP_L1_ATT : FP_L2_ATT);
      bar.wait();
      pf.stamp(layer == 0 ? FP_L1_W : FP_L2_W);
    }
    // ---- mel_proj of group g: x2 @ wm^T; its last frame is the next
    // group's prenet input ----
    {
      const Seg segs[1] = {{wk.x2, L, L}};
      kstage<1, 1, 2>(
          p, X, B, F, segs, 1,
          [&](float(&acc)[1][1][RB], int f, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            kdots<1, false>(acc[0], cs<S>(a.wm) + (size_t)f * L, 0, L, 0, Xt, kcs, c0, c1, nr);
          },
          [&](float(&acc)[1][1][RB], int f, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float mv = rnd<S>(pick(acc[0][0], lane));
              stv(ms<S>(a.mel) + ((gb + b) * F + f), mv);
              if (f >= F - NM && g + 1 < G) {
                const size_t po = (gb + B + b) * NM + f - (F - NM);
                stv(ms<S>(x.s_prev) + po, 0.f + mv);
                if constexpr (BF) wk.prevf[po] = mv;
              }
            }
          });
    }
    pf.stamp(FP_MEL);
    bar.arrive();
    att_slot(g, 2);
    pf.stamp(FP_MEL_ATT);
    bar.wait();
    pf.stamp(FP_MEL_W);
    // ---- the prenet of group g + 1 ----
    if (g + 1 < G) prenet1(g + 1);
    pf.stamp(FP_P1);
    bar.arrive();
    att_slot(g, 3);
    pf.stamp(FP_P1_ATT);
    bar.wait();
    pf.stamp(FP_P1_W);
    if (g + 1 < G) prenet2(g + 1);
    pf.stamp(FP_P2);
    bar.arrive();
    att_slot(g, 4);
    pf.stamp(FP_P2_ATT);
    bar.wait();
    pf.stamp(FP_P2_W);
  }
  // ---- the last group's scores (after every block's last items) ----
  bar.sync();
  for (int m = 0; m < ipb; ++m) {
    const int it = (int)blockIdx.x + m * nblk;
    if (it >= B * nc) break;
    att_fwd_last(a, wk, s_att, nc, it / nc, it % nc);
  }
  pf.stamp(FP_EPI);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BWork {
  float *dah, *dctx, *dh1, *dc1, *dh2, *dc2, *wz1, *wz2, *dx1, *dx2, *dtz;
  float *dctxt, *dsb, *dcum, *contrib, *spart, *dqpart;
  u64* bar;
  int64_t size;
  __host__ __device__ BWork(float* w, const TfBwdArgs& a, const ResPlan& p) {
    Take take{w};
    const int64_t B = a.B;
    dah = take(B * a.D); dctx = take(B * a.E);
    dh1 = take(B * a.L); dc1 = take(B * a.L); dh2 = take(B * a.L); dc2 = take(B * a.L);
    wz1 = take(B * a.L); wz2 = take(B * a.L); dx1 = take(B * a.L); dx2 = take(B * a.L);
    dtz = take(B * a.D);
    dctxt = take(a.G * B * a.E);
    dsb = take(B * a.T); dcum = take(B * a.T);
    contrib = take(B * p.nc * 2 * res::WINP);
    spart = take(B * p.nc);
    dqpart = take(B * p.nc * a.D);
    bar = reinterpret_cast<u64*>(take(4));
    size = take.size;
  }
};

// The location conv's input cotangents over an item's window, summed over
// the units: P[tt][k] = sum_d dp[tt][d] w01t[k][d] for the 62 taps (dp
// through shared memory; a warp per two positions, lanes along d, eight
// taps at a time reduced by reduce_scatter8), then dcl[j] = sum over
// tt + k = j of P[tt][k] for the cumulative's taps and dal[j] likewise for
// the attention's (positions t0 - 15 + j, j < 46). All threads.
template <typename W>
__device__ __forceinline__ void loc_grads(const float (&dp)[TC], int d, bool unit, int D,
                                          const W* w01t, float* s_dp, float* P, float* dcl,
                                          float* dal) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (unit) {
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) s_dp[tt * D + d] = dp[tt];
  }
  __syncthreads();
  for (int tp = 2 * warp; tp < TC; tp += 2 * WARPS) {
    for (int k0 = 0; k0 < NTAP; k0 += 8) {
      float v0[8], v1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v0[u] = v1[u] = 0.f;
#pragma unroll 4
      for (int dd = lane; dd < D; dd += 32) {
        const float p0 = s_dp[tp * D + dd], p1 = s_dp[(tp + 1) * D + dd];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float wv = k0 + u < NTAP ? ldv(w01t + ((k0 + u) * D + dd)) : 0.f;
          v0[u] = fmaf(p0, wv, v0[u]);
          v1[u] = fmaf(p1, wv, v1[u]);
        }
      }
      const float r0 = reduce_scatter8(v0), r1 = reduce_scatter8(v1);
      const int k = k0 + (lane >> 2);
      if ((lane & 3) == 0 && k < NTAP) {
        P[tp * NTAP + k] = r0;
        P[(tp + 1) * NTAP + k] = r1;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < res::WIN) {
    const int j = threadIdx.x;
    float sc = 0.f, sa = 0.f;
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const int k = j - tt;
      if (k >= 0 && k < CONV_K) {
        sc += P[tt * NTAP + k];
        sa += P[tt * NTAP + CONV_K + k];
      }
    }
    dcl[j] = sc;
    dal[j] = sa;
  }
  __syncthreads();
}

// Phase A of a backward attention item (b, c) at group g: d(scores) at its
// positions, from the scores' cotangent and the carries: d(cumulative)
// passes through and gathers the location conv's input cotangents of group
// g + 1 (its own and its neighbours' items'), d(attention) is those alone;
// and the item's partial of S = sum_t ds_t s_t.
__device__ __forceinline__ void att_bwd_a(const TfBwdArgs& a, const BWork& w, float* sc, int G, int nc, int b,
                          int c, int g) {
  const int B = (int)a.B, T = (int)a.T;
  const int t0 = c * TC, tc = min(TC, T - t0);
  __syncthreads();
  if (threadIdx.x < tc) {
    const int t = t0 + threadIdx.x;
    // the three neighbours' contributions, loaded at once, added in order
    float vc[3], va[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c2 = c - 1 + q, j = t - (c2 * TC - CONV_HALF);
      const bool ok = g < G - 1 && c2 >= 0 && c2 < nc && j >= 0 && j < res::WIN;
      const float* cb = w.contrib + ((size_t)b * nc + c2) * 2 * res::WINP;
      vc[q] = ok ? __ldcg(cb + j) : 0.f;
      va[q] = ok ? __ldcg(cb + res::WINP + j) : 0.f;
    }
    const float lc = (vc[0] + vc[1]) + vc[2], la = (va[0] + va[1]) + va[2];
    const size_t bt = (size_t)b * T + t;
    const float dcum = __ldcg(w.dcum + bt) + lc;
    w.dcum[bt] = dcum;
    const size_t o = ((size_t)g * B + b) * T + t;
    const float ds = a.dsc[o] + dcum + la;
    w.dsb[bt] = ds;
    sc[threadIdx.x] = ds * a.scores[o];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int tt = 0; tt < tc; ++tt) s += sc[tt];
    w.spart[(size_t)b * nc + c] = s;
  }
}

// Phase B of a backward attention item: the original's chunk code on its
// positions (the energies' recomputation, d(energy), d(tanh argument),
// d(encp), the v and location-weight gradients into the block's
// accumulators, the conv's input cotangents over the item's window), with
// S from the items' partials; d(q)'s partial over its positions.
template <typename ST>
__device__ __forceinline__ void att_bwd_b(const TfBwdArgs& a, const BWork& w, const ST* s_w01t, float* s_gw,
                          float* s_pv, float* sc, int nc, int b, int c, int g) {
  const int B = (int)a.B, T = (int)a.T, D = (int)a.D;
  const int t0 = c * TC, tc = min(TC, T - t0);
  float* cw = sc;
  float* aw = cw + res::WINP;
  float* dcl = aw + res::WINP;
  float* dal = dcl + res::WINP;
  float* red16 = dal + res::WINP;
  float* su = red16 + WARPS * TC;
  float* sdu = su + TC;
  float* misc = sdu + TC;
  float* P = misc + 16;             // TC x 62
  float* part = P + TC * NTAP;      // nc
  float* s_dp = part + (nc + 3) / 4 * 4;   // TC x D
  const size_t gbb = (size_t)g * B + b;
  __syncthreads();
  const float ssum = ordered_sum(w.spart + (size_t)b * nc, nc, part);
  if (threadIdx.x == 0) misc[0] = ssum;
  if (threadIdx.x < res::WINP) {
    const int j = threadIdx.x, t = t0 - CONV_HALF + j;
    const bool in = j < res::WIN && t >= 0 && t < T;
    cw[j] = in ? a.s_cum[gbb * T + t] : 0.f;
    aw[j] = in && g > 0 ? a.scores[(gbb - B) * T + t] : 0.f;
  }
  __syncthreads();
  const float S = misc[0];
  const float div = a.s_div[gbb];
  const int d = threadIdx.x;
  const bool unit = d < D;
  const float qd = unit ? a.s_q[gbb * D + d] : 0.f, vd = unit ? ldv(cs<ST>(a.v) + d) : 0.f;
  float arg[TC], dp[TC];
  if (unit) {
    lsa_args(arg, 0, tc, d, D, qd, cw, aw, s_w01t, cs<ST>(a.encp) + ((size_t)b * T + t0) * D);
  } else {
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) arg[tt] = 0.f;
  }
  lsa_u(arg, vd, red16, su);
  if (threadIdx.x < tc) {
    const int t = t0 + threadIdx.x;
    const float sig = sigm(su[threadIdx.x]);
    const float ds = __ldcg(w.dsb + (size_t)b * T + t);
    const float dsig = div > 0.f ? (ds - S) / div : ds;
    sdu[threadIdx.x] = dsig * sig * (1.f - sig);
  }
  __syncthreads();
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) dp[tt] = 0.f;
  if (unit) {
    float* dencp_b = a.dencp + (size_t)b * T * D;
    float old[TC];
#pragma unroll
    for (int tt = 0; tt < TC; ++tt)
      if (tt < tc) old[tt] = __ldcg(dencp_b + (size_t)(t0 + tt) * D + d);
    float dv_d = 0.f, dq_d = 0.f;
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      if (tt < tc) {
        const float ar = arg[tt], du = sdu[tt];
        dp[tt] = du * vd * (1.f - ar * ar);
        dv_d = fmaf(du, ar, dv_d);
        dq_d += dp[tt];
        dencp_b[(size_t)(t0 + tt) * D + d] = old[tt] + dp[tt];
      }
    }
#pragma unroll 1
    for (int k = 0; k < CONV_K; ++k) {
      float gc = 0.f, ga = 0.f;
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) {
        gc = fmaf(dp[tt], cw[tt + k], gc);
        ga = fmaf(dp[tt], aw[tt + k], ga);
      }
      s_gw[k * D + d] += gc;
      s_gw[(CONV_K + k) * D + d] += ga;
    }
    s_pv[d] += dv_d;
    w.dqpart[((size_t)b * nc + c) * D + d] = dq_d;
  }
  loc_grads(dp, d, unit, D, s_w01t, s_dp, P, dcl, dal);
  if (threadIdx.x < res::WINP) {
    float* cb = w.contrib + ((size_t)b * nc + c) * 2 * res::WINP;
    cb[threadIdx.x] = dcl[threadIdx.x];
    cb[res::WINP + threadIdx.x] = dal[threadIdx.x];
  }
}

// Phase C: d(q) of group g from the items' partials, into c_dq (the
// wq-gradient reduction and the mel chain's dah read it).
__device__ __forceinline__ void att_bwd_c(const TfBwdArgs& a, const BWork& w, int nblk, int nc, int g) {
  const int B = (int)a.B, D = (int)a.D;
  for (int o = blockIdx.x * THREADS + threadIdx.x; o < B * D; o += nblk * THREADS) {
    const int b = o / D, d = o - b * D;
    const float* src = w.dqpart + (size_t)b * nc * D + d;
    float s = 0.f;
    for (int k0 = 0; k0 < nc; k0 += 8) {   // eight loads in flight, added in order
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = k0 + q < nc ? __ldcg(src + (size_t)(k0 + q) * D) : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (k0 + q < nc) s += v[q];
    }
    a.c_dq[((size_t)g * B + b) * D + d] = s;
  }
}

// The contraction's gradients, formed once after the last group, tasks of
// (utterance b, tt positions): the positions' enc rows and chunks of gc
// groups' dctx in shared memory; d(aref)[g, b, t] = dctx . enc_t with the
// original's order (lanes along e, e = e0 + lane + 32 i, then the xor
// butterfly), d(enc)[b, t] = sum over g from G - 1 down to 0 of aref[g, b,
// t] dctx[g] by fmaf, as the original accumulated it group by group.
template <typename S>
__device__ __forceinline__ void contraction(const TfBwdArgs& a, const AfBwdArgs& x, const BWork& w,
                            const ResPlan& p, float* sm) {
  const int G = (int)a.G, B = (int)a.B, T = (int)a.T, E = (int)a.E, E4 = E / 4;
  const int tt = (int)p.epi_tt, gc = (int)p.epi_gc, nblk = (int)p.nblk;
  const int ntile = (T + tt - 1) / tt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s_enc = sm;                          // tt x E
  float* s_dc = s_enc + (size_t)tt * E;       // gc x E
  float* s_ar = s_dc + (size_t)gc * E;        // gc x tt
  constexpr int NA = 8;                       // d(enc) float4s a thread (plan: tt * E4 <= 8 * 256)
  for (int task = blockIdx.x; task < B * ntile; task += nblk) {
    const int b = task / ntile, t0 = (task % ntile) * tt, tn = min(tt, T - t0);
    float4 acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int e = threadIdx.x; e < tn * E4; e += THREADS)
      reinterpret_cast<float4*>(s_enc)[e] = ldg4i(cs<S>(a.enc) + ((size_t)b * T + t0) * E, e);
    for (int g1 = G; g1 > 0; g1 -= gc) {
      const int g0 = max(0, g1 - gc), gn = g1 - g0;
      __syncthreads();
      for (int e = threadIdx.x; e < gn * E4; e += THREADS) {
        const int gi = e / E4, k = e - gi * E4;
        reinterpret_cast<float4*>(s_dc)[e] = __ldcg(
            reinterpret_cast<const float4*>(w.dctxt + ((size_t)(g0 + gi) * B + b) * E) + k);
      }
      for (int e = threadIdx.x; e < gn * tt; e += THREADS) {
        const int gi = e / tt, ti = e - gi * tt;
        s_ar[e] = ti < tn ? ldv(cs<S>(x.aref) + (((size_t)(g0 + gi) * B + b) * T + t0 + ti)) : 0.f;
      }
      __syncthreads();
      // d(enc): thread i owns float4 outputs i, i + 256, ... of tn x E4
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int o = threadIdx.x + i * THREADS;
        if (o < tn * E4) {
          const int ti = o / E4, k = o - ti * E4;
          for (int gi = gn - 1; gi >= 0; --gi) {
            const float st = s_ar[gi * tt + ti];
            const float4 v = reinterpret_cast<const float4*>(s_dc + (size_t)gi * E)[k];
            acc[i].x = fmaf(st, v.x, acc[i].x);
            acc[i].y = fmaf(st, v.y, acc[i].y);
            acc[i].z = fmaf(st, v.z, acc[i].z);
            acc[i].w = fmaf(st, v.w, acc[i].w);
          }
        }
      }
      // d(aref): a warp per (group, position)
      for (int q = warp; q < gn * tn; q += WARPS) {
        const int gi = q / tn, ti = q - gi * tn;
        const float* dc = s_dc + (size_t)gi * E;
        const float* en = s_enc + (size_t)ti * E;
        float s = 0.f;
        for (int e0 = 0; e0 < E; e0 += 32 * 8) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = e0 + lane + 32 * i;
            if (e < E) s = fmaf(dc[e], en[e], s);
          }
        }
        s = warp_sum(s);
        if (lane == 0) x.daref[((size_t)(g0 + gi) * B + b) * T + t0 + ti] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int o = threadIdx.x + i * THREADS;
      if (o < tn * E4)
        reinterpret_cast<float4*>(a.denc + ((size_t)b * T + t0) * E)[o] = acc[i];
    }
  }
}

enum BProf {
  BP_PRO, BP_S1, BP_S1_ATT, BP_S1_W, BP_S2, BP_S2_W, BP_S3, BP_S3_ATT, BP_S3_W, BP_S4, BP_S4_ATT,
  BP_S4_W, BP_S7, BP_S7_ATT, BP_S7_W, BP_S8, BP_S8_ATT, BP_S8_W, BP_S9, BP_S9_W, BP_EPI
};

// S as in fwd_res: the weights, the streams and the masks are read as S;
// every cotangent and gradient stays float.
template <bool PROF, typename S>
__device__ __forceinline__ void bwd_res(const TfBwdArgs& a, const AfBwdArgs& x, const ResPlan& p,
                                        long long* prof_out) {
  const int G = (int)a.G, B = (int)a.B, E = (int)a.E, D = (int)a.D;
  const int P2 = (int)a.P2, L = (int)a.L, F = (int)a.F, P1 = (int)x.P1, NM = (int)x.NM;
  const int nblk = (int)p.nblk, nc = (int)p.nc, ipb = (int)p.ipb;
  const int lane = threadIdx.x & 31;
  BWork wk(a.work, a, p);
  Bar bar{wk.bar, (u64)nblk, 0};
  Prof pf;
  pf.start(PROF ? prof_out : nullptr);

  extern __shared__ float smem[];
  S* s_w01t = ms<S>(smem + p.off_w01t);
  float* s_att = smem + p.off_att;
  float* X = smem + p.off_x;
  float* s_gw = p.gw_global ? a.pw01 + (size_t)blockIdx.x * NTAP * D : smem + p.off_gw;
  float* s_pv = smem + p.off_pv;
  for (int e = threadIdx.x; e < NTAP * D; e += THREADS) {
    s_w01t[e] = cs<S>(a.w01t)[e];
    s_gw[e] = 0.f;
  }
  for (int e = threadIdx.x; e < D; e += THREADS) s_pv[e] = 0.f;
  __syncthreads();

  // this block's items: phase A or B of group g, items [m0, m1)
  auto items = [&](int phase, int g, int m0, int m1) {
    for (int m = m0; m < m1; ++m) {
      const int it = (int)blockIdx.x + m * nblk;
      if (it >= B * nc) break;
      if (phase == 0)
        att_bwd_a(a, wk, s_att, G, nc, it / nc, it % nc, g);
      else
        att_bwd_b(a, wk, s_w01t, s_gw, s_pv, s_att, nc, it / nc, it % nc, g);
    }
  };
  auto bslot = [&](int g, int s) {   // phase B of group g, slot s of 4
    if (g >= 0) items(1, g, s, s < 3 ? s + 1 : ipb);
  };
  // the attention chain runs a group ahead of the mel chain
  items(0, G - 1, 0, ipb);
  bar.sync();
  items(1, G - 1, 0, ipb);
  bar.sync();
  pf.stamp(BP_PRO);

  for (int g = G - 1; g >= 0; --g) {
    const size_t gb = (size_t)g * B;
    // ---- 1: dx2 = dmel @ wm, then LSTM2's cell backward ----
    {
      const Seg segs[1] = {{a.dmel + gb * F, F, F}};
      kstage<1, 1, 2>(
          p, X, B, L, segs, 1,
          [&](float(&acc)[1][1][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            kdots<1, false>(acc[0], cs<S>(a.wmT) + (size_t)j * F, 0, F, 0, Xt, kcs, c0, c1, nr);
          },
          [&](float(&acc)[1][1][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const size_t o = (size_t)b * L + j, so = (gb + b) * L + j;
              const float dx2 = pick(acc[0][0], lane);
              const float cp = g > 0 ? ldv(cs<S>(a.s_c2) + (so - (size_t)B * L)) : 0.f;
              const LstmBwd r = lstm_bwd(__ldcg(wk.dh2 + o) + dx2, __ldcg(wk.dc2 + o),
                                         cs<S>(a.s_g2) + (gb + b) * 4 * L, j, L,
                                         ldv(cs<S>(a.s_c2) + so), cp, ldv(cs<S>(a.zm2) + so));
              float* dg = a.c_dg2 + (gb + b) * 4 * L;
              for (int q = 0; q < 4; ++q) dg[q * L + j] = r.dg[q];
              wk.dc2[o] = r.dc_prev;
              wk.wz2[o] = r.wz;
              wk.dx2[o] = dx2;
            }
          });
    }
    pf.stamp(BP_S1);
    bar.arrive();
    // d(q) of group g, and phase A of group g - 1
    att_bwd_c(a, wk, nblk, nc, g);
    if (g > 0) items(0, g - 1, 0, ipb);
    pf.stamp(BP_S1_ATT);
    bar.wait();
    pf.stamp(BP_S1_W);
    // ---- 2: dx1 = dx2 + dG2 @ l2wi, dh2 = z dh + dG2 @ l2wh, LSTM1 ----
    // ---- 3: dx0 = dx1 + dG1 @ l1wi, dh1 = z dh + dG1 @ l1wh ----
    for (int layer = 2; layer >= 1; --layer) {
      const float* dG = (layer == 2 ? a.c_dg2 : a.c_dg1) + gb * 4 * L;
      const S* wiT = cs<S>(layer == 2 ? a.l2wiT : a.l1wiT);
      const S* whT = cs<S>(layer == 2 ? a.l2whT : a.l1whT);
      const Seg segs[1] = {{dG, 4 * L, 4 * L}};
      kstage<1, 2, 2>(
          p, X, B, L, segs, 1,
          [&](float(&acc)[2][1][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            kdots<1, false>(acc[0], wiT + (size_t)j * 4 * L, 0, 4 * L, 0, Xt, kcs, c0, c1, nr);
            kdots<1, false>(acc[1], whT + (size_t)j * 4 * L, 0, 4 * L, 0, Xt, kcs, c0, c1, nr);
          },
          [&](float(&acc)[2][1][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const size_t o = (size_t)b * L + j, so = (gb + b) * L + j;
              if (layer == 2) {
                const float dx1 = __ldcg(wk.dx2 + o) + pick(acc[0][0], lane);
                wk.dh2[o] = __ldcg(wk.wz2 + o) + pick(acc[1][0], lane);
                const float cp = g > 0 ? ldv(cs<S>(a.s_c1) + (so - (size_t)B * L)) : 0.f;
                const LstmBwd r = lstm_bwd(__ldcg(wk.dh1 + o) + dx1, __ldcg(wk.dc1 + o),
                                           cs<S>(a.s_g1) + (gb + b) * 4 * L, j, L,
                                           ldv(cs<S>(a.s_c1) + so), cp, ldv(cs<S>(a.zm1) + so));
                float* dg = a.c_dg1 + (gb + b) * 4 * L;
                for (int q = 0; q < 4; ++q) dg[q * L + j] = r.dg[q];
                wk.dc1[o] = r.dc_prev;
                wk.wz1[o] = r.wz;
                wk.dx1[o] = dx1;
              } else {
                a.c_dx0[so] = __ldcg(wk.dx1 + o) + pick(acc[0][0], lane);
                wk.dh1[o] = __ldcg(wk.wz1 + o) + pick(acc[1][0], lane);
              }
            }
          });
      if (layer == 2) {
        pf.stamp(BP_S2);
        bar.sync();
        pf.stamp(BP_S2_W);
      } else {
        pf.stamp(BP_S3);
        bar.arrive();
        bslot(g - 1, 0);
        pf.stamp(BP_S3_ATT);
        bar.wait();
        pf.stamp(BP_S3_W);
      }
    }
    // ---- 4: dctx_t = dctx + (dx0 @ wr)[:E] (kept for the contraction);
    // dah = dah + (dx0 @ wr)[E:] + dq @ wq, then the GRU cell's backward ----
    {
      const Seg segs[2] = {{a.c_dx0 + gb * L, L, L}, {a.c_dq + gb * D, D, D}};
      kstage<1, 2, 2>(
          p, X, B, E + D, segs, 2,
          [&](float(&acc)[2][1][RB], int u, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            kdots<1, false>(acc[0], cs<S>(a.wrT) + (size_t)u * L, 0, L, 0, Xt, kcs, c0, c1, nr);
            if (u >= E)
              kdots<1, false>(acc[1], cs<S>(a.wqT) + (size_t)(u - E) * D, 0, D, L, Xt, kcs, c0, c1,
                              nr);
          },
          [&](float(&acc)[2][1][RB], int u, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float v = pick(acc[0][0], lane);
              if (u < E) {
                wk.dctxt[(gb + b) * E + u] = __ldcg(wk.dctx + (size_t)b * E + u) + v;
              } else {
                const int j = u - E;
                const float dahp = __ldcg(wk.dah + (size_t)b * D + j) + v;
                const float dh = dahp + pick(acc[1][0], lane);
                const size_t gbb = gb + b;
                const S* sg = cs<S>(a.s_gru) + gbb * 4 * D;
                const float r = ldv(sg + j), z = ldv(sg + (D + j)), n = ldv(sg + (2 * D + j)),
                            hn = ldv(sg + (3 * D + j));
                const float hp = g > 0 ? ldv(cs<S>(a.s_ah) + ((gbb - B) * D + j)) : 0.f;
                const float dz = dh * (hp - n);
                const float dn = dh * (1.f - z);
                const float dpre_n = dn * (1.f - n * n);
                const float dpre_r = (dpre_n * hn) * r * (1.f - r);
                const float dpre_z = dz * z * (1.f - z);
                float* gi = a.c_dgi + gbb * 3 * D;
                float* gh = a.c_dgh + gbb * 3 * D;
                gi[j] = dpre_r;
                gi[D + j] = dpre_z;
                gi[2 * D + j] = dpre_n;
                gh[j] = dpre_r;
                gh[D + j] = dpre_z;
                gh[2 * D + j] = dpre_n * r;
                wk.dtz[(size_t)b * D + j] = dh * z;
              }
            }
          });
    }
    pf.stamp(BP_S4);
    bar.arrive();
    bslot(g - 1, 1);
    pf.stamp(BP_S4_ATT);
    bar.wait();
    pf.stamp(BP_S4_W);
    // ---- 7: dpre = dgi @ awi[:, E:], through the second prenet layer ----
    {
      const Seg segs[1] = {{a.c_dgi + gb * 3 * D, 3 * D, 3 * D}};
      kstage<1, 1, 1>(
          p, X, B, P2, segs, 1,
          [&](float(&acc)[1][1][RB], int j, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            kdots<1, false>(acc[0], cs<S>(a.awiT) + (size_t)(E + j) * 3 * D, 0, 3 * D, 0, Xt, kcs,
                            c0, c1, nr);
          },
          [&](float(&acc)[1][1][RB], int j, int, int b0, int nr) {
            if (lane < nr) {
              const size_t o = (gb + b0 + lane) * P2 + j;
              const float v = 0.f + pick(acc[0][0], lane);
              x.c_dp2[o] = ldv(cs<S>(a.pre) + o) > 0.f ? v * ldv(cs<S>(x.dm2) + o) : 0.f;
            }
          });
    }
    pf.stamp(BP_S7);
    bar.arrive();
    bslot(g - 1, 2);
    pf.stamp(BP_S7_ATT);
    bar.wait();
    pf.stamp(BP_S7_W);
    // ---- 8: dp1 = (dp2 @ w2) [p1 > 0] dm1; dctx = dgi @ awi[:, :E] and
    // dah = dah z + dgh @ awh for group g - 1 ----
    {
      const Seg segs[3] = {{x.c_dp2 + gb * P2, P2, P2},
                           {a.c_dgi + gb * 3 * D, 3 * D, 3 * D},
                           {a.c_dgh + gb * 3 * D, 3 * D, 3 * D}};
      kstage<1, 1, 3>(
          p, X, B, P1 + E + D, segs, 3,
          [&](float(&acc)[1][1][RB], int u, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            if (u < P1)
              kdots<1, false>(acc[0], cs<S>(x.w2T) + (size_t)u * P2, 0, P2, 0, Xt, kcs, c0, c1,
                              nr);
            else if (u < P1 + E)
              kdots<1, false>(acc[0], cs<S>(a.awiT) + (size_t)(u - P1) * 3 * D, 0, 3 * D, P2, Xt,
                              kcs, c0, c1, nr);
            else
              kdots<1, false>(acc[0], cs<S>(a.awhT) + (size_t)(u - P1 - E) * 3 * D, 0, 3 * D,
                              P2 + 3 * D, Xt, kcs, c0, c1, nr);
          },
          [&](float(&acc)[1][1][RB], int u, int, int b0, int nr) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float v = pick(acc[0][0], lane);
              if (u < P1) {
                const size_t o = (gb + b) * P1 + u;
                const float s1 = 0.f + v;
                x.c_dp1[o] = ldv(cs<S>(x.s_p1) + o) > 0.f ? s1 * ldv(cs<S>(x.dm1) + o) : 0.f;
              } else if (u < P1 + E) {
                wk.dctx[(size_t)b * E + u - P1] = v;
              } else {
                const size_t o = (size_t)b * D + u - P1 - E;
                wk.dah[o] = __ldcg(wk.dtz + o) + v;
              }
            }
          });
    }
    pf.stamp(BP_S8);
    bar.arrive();
    bslot(g - 1, 3);
    pf.stamp(BP_S8_ATT);
    bar.wait();
    pf.stamp(BP_S8_W);
    // ---- 9: d(prev) = dp1 @ w1 joins the last frame of group g-1's dmel ----
    if (g > 0) {
      const Seg segs[1] = {{x.c_dp1 + gb * P1, P1, P1}};
      kstage<1, 1, 1>(
          p, X, B, NM, segs, 1,
          [&](float(&acc)[1][1][RB], int m, int, const float* Xt, int kcs, int c0, int c1,
              int nr) {
            kdots<1, false>(acc[0], cs<S>(x.w1T) + (size_t)m * P1, 0, P1, 0, Xt, kcs, c0, c1, nr);
          },
          [&](float(&acc)[1][1][RB], int m, int, int b0, int nr) {
            if (lane < nr) {
              float* dm = x.dmel + (gb - B + b0 + lane) * F + F - NM + m;
              *dm = __ldcg(dm) + (0.f + pick(acc[0][0], lane));
            }
          });
    }
    pf.stamp(BP_S9);
    bar.sync();
    pf.stamp(BP_S9_W);
  }
  // ---- the block's v and location-weight gradients, then the contraction
  __syncthreads();
  float* pw = a.pw01 + (size_t)blockIdx.x * NTAP * D;
  if (!p.gw_global)
    for (int e = threadIdx.x; e < NTAP * D; e += THREADS) pw[e] = s_gw[e];
  for (int e = threadIdx.x; e < D; e += THREADS) a.pv[(size_t)blockIdx.x * D + e] = s_pv[e];
  contraction<S>(a, x, wk, p, smem + 4);
  pf.stamp(BP_EPI);
}

}  // namespace res

namespace {

#ifndef TACO_TRAIN_HELPERS_ONLY   // taco_tf_resident.cu takes the helpers alone
__global__ void __launch_bounds__(THREADS, 1)
    taco_af_res_fwd(TfFwdArgs a, AfFwdArgs x, ResPlan p) {
  res::fwd_res<false, float>(a, x, p, nullptr);
}
__global__ void __launch_bounds__(THREADS, 1)
    taco_af_res_fwd_prof(TfFwdArgs a, AfFwdArgs x, ResPlan p, long long* prof) {
  res::fwd_res<true, float>(a, x, p, prof);
}
__global__ void __launch_bounds__(THREADS, 1)
    taco_af_res_bwd(TfBwdArgs a, AfBwdArgs x, ResPlan p) {
  res::bwd_res<false, float>(a, x, p, nullptr);
}
__global__ void __launch_bounds__(THREADS, 1)
    taco_af_res_bwd_prof(TfBwdArgs a, AfBwdArgs x, ResPlan p, long long* prof) {
  res::bwd_res<true, float>(a, x, p, prof);
}
// the bf16 instantiations (weights, streams, saved states and mel in bf16)
__global__ void __launch_bounds__(THREADS, 1)
    taco_af_res_fwd_bf16(TfFwdArgs a, AfFwdArgs x, ResPlan p) {
  res::fwd_res<false, bf16_t>(a, x, p, nullptr);
}
__global__ void __launch_bounds__(THREADS, 1)
    taco_af_res_bwd_bf16(TfBwdArgs a, AfBwdArgs x, ResPlan p) {
  res::bwd_res<false, bf16_t>(a, x, p, nullptr);
}

#endif

cudaError_t launch_res(const void* fn, const ResPlan& p, void** kargs, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem_bytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, (size_t)p.smem_bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || p.nblk > (int64_t)sms * per_sm) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)p.nblk), dim3(THREADS), kargs,
                                  (size_t)p.smem_bytes, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// wgrads() with the location-weight and v partials one per block of the
// grid (the original has one per utterance).
template <typename S>
cudaError_t res_wgrads(const TfBwdArgs& a, const AfBwdArgs& x, int64_t nparts, cudaStream_t st) {
  cudaError_t e;
  const int64_t R = a.G * a.B, B = a.B, D = a.D, E = a.E, P2 = a.P2, L = a.L, F = a.F;
  const S *s_ctx = cs<S>(a.s_ctx), *s_ah = cs<S>(a.s_ah);
  if ((e = gemm(st, a.c_dgi, 3 * D, s_ctx, E, B, a.dawi, E + P2, 3 * D, E, R))) return e;
  if ((e = gemm(st, a.c_dgi, 3 * D, cs<S>(a.pre), P2, 0, a.dawi + E, E + P2, 3 * D, P2, R)))
    return e;
  if ((e = csum(st, a.c_dgi, 3 * D, a.dabi, 3 * D, R))) return e;
  if ((e = gemm(st, a.c_dgh, 3 * D, s_ah, D, B, a.dawh, D, 3 * D, D, R))) return e;
  if ((e = csum(st, a.c_dgh, 3 * D, a.dabh, 3 * D, R))) return e;
  if ((e = gemm(st, a.c_dq, D, s_ah, D, 0, a.dwq, D, D, D, R))) return e;
  if ((e = csum(st, a.c_dq, D, a.dqb, D, R))) return e;
  if ((e = gemm(st, a.c_dx0, L, s_ctx, E, 0, a.dwr, E + D, L, E, R))) return e;
  if ((e = gemm(st, a.c_dx0, L, s_ah, D, 0, a.dwr + E, E + D, L, D, R))) return e;
  if ((e = csum(st, a.c_dx0, L, a.dbr, L, R))) return e;
  if ((e = gemm(st, a.c_dg1, 4 * L, cs<S>(a.s_x0), L, 0, a.dl1wi, L, 4 * L, L, R))) return e;
  if ((e = gemm(st, a.c_dg1, 4 * L, cs<S>(a.s_h1), L, B, a.dl1wh, L, 4 * L, L, R))) return e;
  if ((e = csum(st, a.c_dg1, 4 * L, a.dl1b, 4 * L, R))) return e;
  if ((e = gemm(st, a.c_dg2, 4 * L, cs<S>(a.s_x1), L, 0, a.dl2wi, L, 4 * L, L, R))) return e;
  if ((e = gemm(st, a.c_dg2, 4 * L, cs<S>(a.s_h2), L, B, a.dl2wh, L, 4 * L, L, R))) return e;
  if ((e = csum(st, a.c_dg2, 4 * L, a.dl2b, 4 * L, R))) return e;
  if ((e = gemm(st, a.dmel, F, cs<S>(a.s_x2), L, 0, a.dwm, L, F, L, R))) return e;
  const int64_t P1 = x.P1, NM = x.NM;
  if ((e = gemm(st, x.c_dp2, P2, cs<S>(x.s_p1), P1, 0, x.dw2, P1, P2, P1, R))) return e;
  if ((e = csum(st, x.c_dp2, P2, x.db2, P2, R))) return e;
  if ((e = gemm(st, x.c_dp1, P1, cs<S>(x.s_prev), NM, 0, x.dw1, NM, P1, NM, R))) return e;
  if ((e = csum(st, x.c_dp1, P1, x.db1, P1, R))) return e;
  reduce_parts<<<(unsigned)((NTAP * D + 255) / 256), 256, 0, st>>>(a.pw01, (int)nparts, NTAP,
                                                                    (int)D, 1, a.dw01);
  if ((e = cudaGetLastError())) return e;
  reduce_parts<<<(unsigned)((D + 255) / 256), 256, 0, st>>>(a.pv, (int)nparts, 1, (int)D, 0,
                                                            a.dv);
  return cudaGetLastError();
}

}  // namespace

#ifndef TACO_TRAIN_HELPERS_ONLY   // taco_tf_resident.cu takes the helpers alone
extern "C" {

// Floats of zeroed workspace the resident forward / backward needs.
int64_t wr_taco_af_res_fwd_work_floats(const TfFwdArgs* a, const ResPlan* p) {
  return res::FWork<float>(nullptr, *a, *p).size;
}
int64_t wr_taco_af_res_fwd_bf16_work_floats(const TfFwdArgs* a, const AfFwdArgs* x,
                                            const ResPlan* p) {
  return res::FWork<bf16_t>(nullptr, *a, *p, x).size;
}
int64_t wr_taco_af_res_bwd_work_floats(const TfBwdArgs* a, const ResPlan* p) {
  return res::BWork(nullptr, *a, *p).size;
}

// The forward over all G groups on `stream` (prof: null, or 64 int64
// counters on the device for the profiling instantiation); returns the
// CUDA error code.
int wr_taco_af_res_fwd(const TfFwdArgs* args, const AfFwdArgs* xargs, const ResPlan* plan,
                       long long* prof, void* stream) {
  TfFwdArgs a = *args;
  AfFwdArgs x = *xargs;
  ResPlan p = *plan;
  if (a.pre != x.s_pre || a.D > THREADS) return cudaErrorInvalidValue;
  if (prof) {
    void* kargs[] = {&a, &x, &p, &prof};
    return launch_res((const void*)taco_af_res_fwd_prof, p, kargs, (cudaStream_t)stream);
  }
  void* kargs[] = {&a, &x, &p};
  return launch_res((const void*)taco_af_res_fwd, p, kargs, (cudaStream_t)stream);
}

// The backward: the reverse sweep, then every weight gradient from the
// cotangent streams it wrote. Returns the CUDA error code.
int wr_taco_af_res_bwd(const TfBwdArgs* args, const AfBwdArgs* xargs, const ResPlan* plan,
                       long long* prof, void* stream) {
  TfBwdArgs a = *args;
  AfBwdArgs x = *xargs;
  ResPlan p = *plan;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.dmel != x.dmel || a.D > THREADS) return cudaErrorInvalidValue;
  cudaError_t e;
  if (prof) {
    void* kargs[] = {&a, &x, &p, &prof};
    e = launch_res((const void*)taco_af_res_bwd_prof, p, kargs, st);
  } else {
    void* kargs[] = {&a, &x, &p};
    e = launch_res((const void*)taco_af_res_bwd, p, kargs, st);
  }
  if (e != cudaSuccess) return e;
  return res_wgrads<float>(a, x, p.nblk, st);
}

// The bf16 forward and backward (every operand of ops/cuda_taco_train.py's
// bf16 class in bf16; scores, s_cum, s_q, s_div, the biases, dmel, dsc and
// every cotangent and gradient in float).
int wr_taco_af_res_fwd_bf16(const TfFwdArgs* args, const AfFwdArgs* xargs, const ResPlan* plan,
                            void* stream) {
  TfFwdArgs a = *args;
  AfFwdArgs x = *xargs;
  ResPlan p = *plan;
  if (a.pre != x.s_pre || a.D > THREADS) return cudaErrorInvalidValue;
  void* kargs[] = {&a, &x, &p};
  return launch_res((const void*)taco_af_res_fwd_bf16, p, kargs, (cudaStream_t)stream);
}
int wr_taco_af_res_bwd_bf16(const TfBwdArgs* args, const AfBwdArgs* xargs, const ResPlan* plan,
                            void* stream) {
  TfBwdArgs a = *args;
  AfBwdArgs x = *xargs;
  ResPlan p = *plan;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.dmel != x.dmel || a.D > THREADS) return cudaErrorInvalidValue;
  void* kargs[] = {&a, &x, &p};
  const cudaError_t e = launch_res((const void*)taco_af_res_bwd_bf16, p, kargs, st);
  if (e != cudaSuccess) return e;
  return res_wgrads<bf16_t>(a, x, p.nblk, st);
}

}  // extern "C"
#endif  // TACO_TRAIN_HELPERS_ONLY
