// Greedy beam search over inline neighbour blocks, hand-written CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel rangefilteredann_tpu/ops/pallas_beam.py::_beam_kernel
// (wrapper _pallas_beam_search_inline). Bound from PyTorch by ctypes through
// rangefilteredann_tpu_torch/ops/beam.py, whose plain version is
// ops/beam_search.batched_beam_search(expand=1, k=0, inline blocks).
//
// What it computes, for each query q (the plain version's function):
//   * init: an active query's frontier is slot 0 = (d0[q], starts[q]) and
//     (+inf, EMPTY_ID) elsewhere, n_vis = 0, cmps = 1; an inactive query
//     returns an empty frontier and zero counters.
//   * while some slot is unexplored and n_vis < limit: expand the first
//     unexplored slot of the (dist, id)-sorted frontier; read the node's R
//     neighbour ids, norms and its [R, w] block of neighbour vectors; the
//     distance of candidate j is nrm_j - 2 ip_j (L2, shifted) or -ip_j
//     (MIPS), ip_j = scale[node] * (q . x_j) for int8-quantized blocks;
//     every candidate with id >= 0 counts in cmps.
//   * a candidate is admitted when its id is valid and its distance is
//     strictly below the pre-step tail distance; an admitted id already in
//     the frontier is dropped (the frontier copy wins, whatever its
//     distance), and of an id admitted twice the first copy wins; the
//     survivors and the frontier are merged by (dist, id) and the first
//     `beam` slots kept, each with its explored flag.
// The duplicate test is by id, not by (dist, id): the start's d0 comes from
// the full store row, and int8 blocks with a scale quantize per owner node,
// so one id can carry two distances in one search.
// Blocks of fp32, bf16 (upcast), native int8/uint8 and int8 with a per-node
// scale; for byte blocks the wrapper rounds the query to bf16 first (byte x
// bf16 products are exact in fp32), as the reference's operand policy does.
//
// Bound on an H100 SXM. A step reads one block of R * w elements plus R ids
// and norms (24,960 bytes at R = 48, w = 128 fp32) and does 2 * R * w flops:
// about 1/2 flop per fp32 byte, far below the card's balance point, so a
// full launch is bound by the bytes of its expansions (sum of n_vis x block
// bytes over 3.35 TB/s) once enough of them are in flight, and a launch of
// few queries by the latency of one step: select -> block load -> reduce ->
// merge, each waiting on the last. Measured on the card (PERF.md):
// while a block arrived in dependent rounds of register loads, the step's
// latency bound the full launches too (more warps with fewer loads each ran
// slower; an L2 prefetch of the next block gained 8%); with the whole block
// in flight they read ~2 TB/s of expansion bytes, and more queries an SM
// gained nothing more.
//
// What the design does about it:
//   * The whole block in flight at once, fetched while merging. A node's
//     block (R * w * elem contiguous bytes) is copied into the query's
//     shared memory by one bulk copy of the tensor memory accelerator
//     (cp.async.bulk, completing on an mbarrier), its ids, norms and scale
//     by cp.async; neither holds registers. As soon as the candidates are
//     known, the next node is the smaller, in (dist, id) order, of the
//     first unexplored old slot after the expanded one and the best
//     surviving candidate; its copy is issued before the merge, and the
//     next step waits for it only if the merge was shorter. (Measured on
//     the card, PERF.md: the bulk copy was a little faster than 16-byte
//     cp.async by lane, and staging cut ~20% from register loads with an
//     L2 prefetch.)
//   * Distances from shared memory: G lanes (G = 16-byte pieces of a row, up
//     to 32) read one row, lane g the pieces g, g + G, ... Each lane keeps
//     one partial sum per row it touched (an FMA chain over its pieces in
//     column order); a butterfly over the G lanes (G - 1 shuffles for G
//     rows) leaves each lane one row's sum. The summation tree is the same
//     for every row, so a node's distance does not depend on the block or
//     the configuration that computed it.
//   * A parallel merge. One pass a step: the admitted candidates are
//     compacted in candidate order and tested, threads over the frontier's
//     slots and the admitted, against every frontier id and every earlier
//     admitted id; each survivor finds its place by a binary search in the
//     sorted frontier plus its rank among the survivors. The frontier then
//     moves in place, top chunk first, each slot up by the survivors ahead
//     of it, and the survivors drop into their places; the next slot to
//     expand is known already, so no scan selects it.
//   * One CTA per query, in two configurations of one kernel template: one
//     warp, for batches that fill the card (a query's state, its staged
//     block included, is ~29 KB at the main shape, so an SM holds 7); and
//     four warps for small batches, which split the block's rows, the
//     duplicate test and the moves. The wrapper picks by a rule on the batch
//     (ops/beam.py launch_config). The hardware hands a finished CTA's SM to
//     the next query, so no query waits for another.
// State per query in shared memory: control words, the query (4 bytes a
// column), the candidates' scratch (CAND_ARRAYS x MAX_R words), the staged
// block (R * w * elem bytes), the frontier (dist, id, explored flag: 9 bytes
// a slot).
//
// Caps: 1 <= R <= MAX_R, w a multiple of 32 up to MAX_W, 1 <= beam <=
// MAX_BEAM; the wrapper raises outside them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int EMPTY_ID = 0x7fffffff;
constexpr int BLOCKS_PER_SM = 4;  // of the 4-warp configuration (__launch_bounds__)
constexpr int MAX_R = 64;
constexpr int MAX_W = 256;
constexpr int MAX_BEAM = 2048;
constexpr int CTL_BYTES = 32;     // per-query control words
constexpr int CAND_ARRAYS = 11;   // candidate scratch arrays of MAX_R words
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ size_t query_smem_bytes(int beam, int R, int w, size_t elem) {
  return (static_cast<size_t>(CTL_BYTES) + static_cast<size_t>(w) * 4 +
          static_cast<size_t>(CAND_ARRAYS) * MAX_R * 4 + static_cast<size_t>(R) * w * elem +
          static_cast<size_t>(beam) * 9 + 15) / 16 * 16;
}

__device__ __forceinline__ bool lex_lt(float d, int i, float td, int ti) {
  return d < td || (d == td && i < ti);
}

// One 16-byte piece of a row dotted with the matching query columns,
// continuing the FMA chain `acc` in column order.
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int EPP = 4;  // elements per piece
  __device__ static float dot(uint4 v, const float* q, float acc) {
    const float4 a = *reinterpret_cast<const float4*>(q);
    acc = fmaf(a.x, __uint_as_float(v.x), acc);
    acc = fmaf(a.y, __uint_as_float(v.y), acc);
    acc = fmaf(a.z, __uint_as_float(v.z), acc);
    return fmaf(a.w, __uint_as_float(v.w), acc);
  }
};
template <> struct Piece<uint16_t> {  // bfloat16, two a word, the low half first
  static constexpr int EPP = 8;
  __device__ static float dot(uint4 v, const float* q, float acc) {
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(q + 4 * h);
      acc = fmaf(a.x, __uint_as_float(x[2 * h] << 16), acc);
      acc = fmaf(a.y, __uint_as_float(x[2 * h] & 0xffff0000u), acc);
      acc = fmaf(a.z, __uint_as_float(x[2 * h + 1] << 16), acc);
      acc = fmaf(a.w, __uint_as_float(x[2 * h + 1] & 0xffff0000u), acc);
    }
    return acc;
  }
};
template <typename B> struct BytePiece {
  static constexpr int EPP = 16;
  __device__ static float dot(uint4 v, const float* q, float acc) {
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(q + 4 * h);
      acc = fmaf(a.x, static_cast<float>(static_cast<B>(x[h] & 0xffu)), acc);
      acc = fmaf(a.y, static_cast<float>(static_cast<B>((x[h] >> 8) & 0xffu)), acc);
      acc = fmaf(a.z, static_cast<float>(static_cast<B>((x[h] >> 16) & 0xffu)), acc);
      acc = fmaf(a.w, static_cast<float>(static_cast<B>(x[h] >> 24)), acc);
    }
    return acc;
  }
};
template <> struct Piece<int8_t> : BytePiece<int8_t> {};
template <> struct Piece<uint8_t> : BytePiece<uint8_t> {};

// Per-query shared state (one query a CTA).
struct QueryState {
  int* ctl;       // [0] admitted, [1] survivors, [2] best survivor, [3] next slot,
                  // [4] lowest place, [5] the staged node's scale (a float),
                  // [6..7] the block copy's mbarrier
  float* qs;      // [w] the query
  float* cd;      // [MAX_R] candidate distances, by row
  int* cid;       // [MAX_R] candidate ids (EMPTY_ID where invalid)
  float* kd;      // [MAX_R] admitted candidates, in candidate order
  int* kid;
  int* kdup;      // [MAX_R] 1 = the admitted id is a duplicate
  float* sd;      // [MAX_R] survivors, in candidate order
  int* sid;
  int* sp;        // [MAX_R] frontier slots ahead of each survivor
  int* spos;      // [MAX_R] each survivor's place in the merged frontier
  int* bid;       // [MAX_R] the staged node's neighbour ids
  float* bnrm;    // [MAX_R] and their norms
  unsigned char* blk;  // [R * w * elem] the staged node's block
  float* fd;      // [beam] the frontier
  int* fid;
  uint8_t* fe;    // [beam] explored flags

  __device__ QueryState(unsigned char* base, int beam, int w, int blk_bytes) {
    ctl = reinterpret_cast<int*>(base);
    qs = reinterpret_cast<float*>(base + CTL_BYTES);
    cd = qs + w;
    cid = reinterpret_cast<int*>(cd + MAX_R);
    kd = reinterpret_cast<float*>(cid + MAX_R);
    kid = reinterpret_cast<int*>(kd + MAX_R);
    kdup = kid + MAX_R;
    sd = reinterpret_cast<float*>(kdup + MAX_R);
    sid = reinterpret_cast<int*>(sd + MAX_R);
    sp = sid + MAX_R;
    spos = sp + MAX_R;
    bid = spos + MAX_R;
    bnrm = reinterpret_cast<float*>(bid + MAX_R);
    blk = reinterpret_cast<unsigned char*>(bnrm + MAX_R);  // 16-byte aligned
    fd = reinterpret_cast<float*>(blk + blk_bytes);
    fid = reinterpret_cast<int*>(fd + beam);
    fe = reinterpret_cast<uint8_t*>(fid + beam);
  }
};

template <int WPQ>
__device__ __forceinline__ void group_sync() {
  if (WPQ == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Asynchronous copies to shared memory that hold no registers: the block
// by one bulk copy of the tensor memory accelerator, completing on an
// mbarrier; the ids, norms and scale by cp.async, 4 bytes each.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void stage4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void bar_init(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void stage_bulk(void* dst, const void* src, unsigned bytes,
                                           void* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after the reads of dst
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// Every thread waits for its own cp.async copies and for the bulk copy of
// this phase of the mbarrier.
__device__ __forceinline__ void stage_wait(void* bar, unsigned phase) {
  asm volatile("cp.async.wait_all;" ::: "memory");
  unsigned done = 1;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
  } while (!done);
}

// One warp copies a node's block, ids, norms and scale into the query's
// state.
template <typename T>
__device__ __forceinline__ void stage_node(const QueryState& st, const T* vecs, const int* nbrs,
                                           const float* nrms, const float* scale, int node,
                                           int R, int w, int lane) {
  const size_t base = static_cast<size_t>(node) * R;
  if (lane == 0)
    stage_bulk(st.blk, vecs + base * w, static_cast<unsigned>(R * w * sizeof(T)), st.ctl + 6);
  for (int j = lane; j < R; j += 32) {
    stage4(st.bid + j, nbrs + base + j);
    stage4(st.bnrm + j, nrms + base + j);
  }
  if (lane == 0 && scale != nullptr) stage4(st.ctl + 5, scale + node);
}

// The candidates of the staged block: distances into cd, ids into cid, by
// row. Warp wq of the query's WPQ warps takes the row rounds wq, wq + WPQ,
// ...; a round is 32 / G rows, one per group of G lanes.
template <typename T, int G, int WPQ>
__device__ __forceinline__ void candidate_distances(bool scaled, int l2, int R, int w, int wq,
                                                    int lane, const QueryState& st) {
  using P = Piece<T>;
  constexpr int RPR = 32 / G;           // rows a round
  constexpr int LD = G < 16 ? G : 16;   // loads in flight a lane
  const int pieces = w * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces a row
  const int ppl = (pieces + G - 1) / G;
  const int grp = lane / G, g = lane % G;
  const int rounds = (R + RPR - 1) / RPR;
  const uint4* b4 = reinterpret_cast<const uint4*>(st.blk);
  const float sc = scaled ? __int_as_float(st.ctl[5]) : 1.f;
  for (int u0 = 0; wq + WPQ * u0 < rounds; u0 += G) {
    // the row this lane sums up at the end of the batch
    const int my_row = (wq + WPQ * (u0 + g)) * RPR + grp;
    float part[G];
#pragma unroll
    for (int t = 0; t < G; ++t) part[t] = 0.f;
    for (int k = 0; k < ppl; ++k) {
      const int pc = g + G * k;
#pragma unroll
      for (int t0 = 0; t0 < G; t0 += LD) {
        uint4 v[LD];
        bool ok[LD];
#pragma unroll
        for (int t = 0; t < LD; ++t) {
          const int row = (wq + WPQ * (u0 + t0 + t)) * RPR + grp;
          ok[t] = row < R && pc < pieces;
          if (ok[t]) v[t] = b4[row * pieces + pc];
        }
#pragma unroll
        for (int t = 0; t < LD; ++t)
          if (ok[t]) part[t0 + t] = P::dot(v[t], st.qs + pc * P::EPP, part[t0 + t]);
      }
    }
    // butterfly over the G lanes of the group: lane g ends with slot g's sum
#pragma unroll
    for (int o = G / 2; o >= 1; o >>= 1) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float send = up ? part[i] : part[i + o];
        const float keep = up ? part[i + o] : part[i];
        part[i] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
    if (my_row < R) {
      float acc = part[0];
      if (scaled) acc = sc * acc;
      const int id = st.bid[my_row];
      const bool valid = id >= 0;
      st.cd[my_row] = valid ? (l2 ? st.bnrm[my_row] - 2.f * acc : -acc) : INFINITY;
      st.cid[my_row] = valid ? id : EMPTY_ID;
    }
  }
}

template <typename T, int G, int WPQ>
__global__ void __launch_bounds__(32 * WPQ, WPQ == 1 ? 1 : BLOCKS_PER_SM)
beam_search_kernel(const T* __restrict__ vecs,        // [m, R, w]
                   const int* __restrict__ nbrs,      // [m, R]
                   const float* __restrict__ nrms,    // [m, R]
                   const float* __restrict__ scale,   // [m] or nullptr
                   const float* __restrict__ queries, // [Q, w]
                   const int* __restrict__ starts,    // [Q]
                   const float* __restrict__ d0,      // [Q]
                   const uint8_t* __restrict__ active,// [Q]
                   int m, int R, int w, int beam, int limit, int l2,
                   int* __restrict__ out_ids,         // [Q, beam]
                   float* __restrict__ out_d,         // [Q, beam]
                   int* __restrict__ out_nvis,        // [Q]
                   int* __restrict__ out_cmps) {      // [Q]
  constexpr int NT = 32 * WPQ;  // the query's threads: the CTA
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wq = tid >> 5;  // warp 0 steers
  const int q = blockIdx.x;
  const QueryState st(smem, beam, w, R * w * static_cast<int>(sizeof(T)));
  const unsigned lt = (1u << lane) - 1u;

  for (int i = tid; i < beam; i += NT) {
    st.fd[i] = INFINITY;
    st.fid[i] = EMPTY_ID;
    st.fe[i] = 0;
  }
  for (int i = tid; i < w; i += NT) st.qs[i] = queries[static_cast<size_t>(q) * w + i];
  if (tid == 0) bar_init(st.ctl + 6);
  group_sync<WPQ>();
  const bool act = active[q] != 0;
  int s = act && limit > 0 ? 0 : -1;  // the slot to expand
  if (act && wq == 0) {
    if (lane == 0) {
      st.fd[0] = d0[q];
      st.fid[0] = starts[q];
    }
    if (s == 0) stage_node(st, vecs, nbrs, nrms, scale, min(max(starts[q], 0), m - 1), R, w, lane);
  }
  int n_vis = 0, cmps = act ? 1 : 0;  // cmps is kept by warp 0
  int fill = act ? 1 : 0;             // slots [0, fill) hold nodes

  while (s >= 0) {
    // --- the candidates of the expanded node, whose block is staged ---
    stage_wait(st.ctl + 6, n_vis & 1);  // one copy a step: phases alternate
    group_sync<WPQ>();
    ++n_vis;
    candidate_distances<T, G, WPQ>(scale != nullptr, l2, R, w, wq, lane, st);
    group_sync<WPQ>();

    // --- admit below the pre-step tail, compacted in candidate order ---
    if (wq == 0) {
      const float tail = st.fd[beam - 1];
      int n_k = 0;
      for (int j0 = 0; j0 < R; j0 += 32) {
        const int j = j0 + lane;
        const int id = j < R ? st.cid[j] : EMPTY_ID;
        const float d = j < R ? st.cd[j] : INFINITY;
        cmps += __popc(__ballot_sync(FULL, id != EMPTY_ID));
        const bool keep = id != EMPTY_ID && d < tail;
        const unsigned kb = __ballot_sync(FULL, keep);
        if (keep) {
          const int a = n_k + __popc(kb & lt);
          st.kd[a] = d;
          st.kid[a] = id;
          st.kdup[a] = 0;
        }
        n_k += __popc(kb);
      }
      if (lane == 0) st.ctl[0] = n_k;
    }
    group_sync<WPQ>();

    // --- drop an admitted id that the frontier holds (the frontier copy
    // wins) or that an earlier admitted candidate holds (the first wins):
    // items [0, fill) are the frontier's slots, then the admitted ---
    const int n_k = st.ctl[0];
    if (n_k > 0) {
      for (int i = tid; i < fill + n_k; i += NT) {
        const bool slot = i < fill;
        const int id = slot ? st.fid[i] : st.kid[i - fill];
        for (int a = slot ? 0 : i - fill + 1; a < n_k; ++a)
          if (st.kid[a] == id) st.kdup[a] = 1;
      }
    }
    group_sync<WPQ>();

    // --- the survivors' places, the next slot to expand, and its block
    // staged while the frontier merges ---
    if (wq == 0) {
      int n_s = 0;
      for (int a0 = 0; a0 < n_k; a0 += 32) {
        const int a = a0 + lane;
        const bool sv = a < n_k && !st.kdup[a];
        const unsigned sb = __ballot_sync(FULL, sv);
        if (sv) {
          const int b = n_s + __popc(sb & lt);
          st.sd[b] = st.kd[a];
          st.sid[b] = st.kid[a];
        }
        n_s += __popc(sb);
      }
      if (lane == 0) st.fe[s] = 1;
      __syncwarp();
      for (int a = lane; a < n_s; a += 32) {
        const float d = st.sd[a];
        const int id = st.sid[a];
        int lo = 0, hi = fill;  // frontier slots ahead of (d, id)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (lex_lt(st.fd[mid], st.fid[mid], d, id)) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        int rank = 0;  // survivors ahead of it
        for (int b = 0; b < n_s; ++b) rank += lex_lt(st.sd[b], st.sid[b], d, id);
        st.sp[a] = lo;
        st.spos[a] = lo + rank;
        if (rank == 0) st.ctl[2] = a;
      }
      // the first unexplored old slot after s
      int u = -1;
      for (int c = s + 1; c < fill; c += 32) {
        const int i = c + lane;
        const unsigned un = __ballot_sync(FULL, i < fill && !st.fe[i]);
        if (un) {
          u = c + __ffs(un) - 1;
          break;
        }
      }
      __syncwarp();
      int next = -1, next_node = -1;
      const int best = n_s > 0 ? st.ctl[2] : -1;
      if (n_vis < limit) {
        if (best >= 0 && (u < 0 || lex_lt(st.sd[best], st.sid[best], st.fd[u], st.fid[u]))) {
          next = st.spos[best];
          next_node = st.sid[best];
        } else if (u >= 0) {
          int shift = 0;
          for (int a = 0; a < n_s; ++a) shift += st.sp[a] <= u;
          next = u + shift;
          next_node = st.fid[u];
        }
      }
      if (next_node >= 0)
        stage_node(st, vecs, nbrs, nrms, scale, min(next_node, m - 1), R, w, lane);
      if (lane == 0) {
        st.ctl[1] = n_s;
        st.ctl[3] = next;
        st.ctl[4] = best >= 0 ? st.sp[best] : fill;
      }
    }
    group_sync<WPQ>();

    // --- merge in place: each slot from the lowest place up moves up by the
    // survivors ahead of it (top chunk first), then the survivors drop in ---
    const int n_s = st.ctl[1];
    if (n_s > 0) {
      const int lowest = st.ctl[4];
      for (int hi = fill - 1; hi >= lowest; hi -= NT) {
        const int i = hi - tid;
        int to = beam;
        float d = 0.f;
        int id = 0;
        uint8_t e = 0;
        if (i >= lowest) {
          d = st.fd[i];
          id = st.fid[i];
          e = st.fe[i];
          int shift = 0;
          for (int a = 0; a < n_s; ++a) shift += st.sp[a] <= i;
          to = i + shift;
        }
        group_sync<WPQ>();
        if (to < beam) {
          st.fd[to] = d;
          st.fid[to] = id;
          st.fe[to] = e;
        }
      }
      for (int a = tid; a < n_s; a += NT) {
        const int to = st.spos[a];
        if (to < beam) {
          st.fd[to] = st.sd[a];
          st.fid[to] = st.sid[a];
          st.fe[to] = 0;
        }
      }
      fill = min(beam, fill + n_s);
    }
    s = st.ctl[3];
    group_sync<WPQ>();
  }

  group_sync<WPQ>();
  const size_t out = static_cast<size_t>(q) * beam;
  for (int i = tid; i < beam; i += NT) {
    out_ids[out + i] = st.fid[i];
    out_d[out + i] = st.fd[i];
  }
  if (tid == 0) {
    out_nvis[q] = n_vis;
    out_cmps[q] = cmps;
  }
}

struct Args {
  const void* vecs;
  const int* nbrs;
  const float* nrms;
  const float* scale;
  const float* queries;
  const int* starts;
  const float* d0;
  const uint8_t* active;
  int n_q, m, R, w, beam, limit, l2;
  int* out_ids;
  float* out_d;
  int* out_nvis;
  int* out_cmps;
  cudaStream_t stream;
};

template <typename T, int G, int WPQ>
int launch_config(const Args& a) {
  const size_t smem = query_smem_bytes(a.beam, a.R, a.w, sizeof(T));
  auto kernel = beam_search_kernel<T, G, WPQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_q, 32 * WPQ, smem, a.stream>>>(
      static_cast<const T*>(a.vecs), a.nbrs, a.nrms, a.scale, a.queries, a.starts, a.d0,
      a.active, a.m, a.R, a.w, a.beam, a.limit, a.l2, a.out_ids, a.out_d, a.out_nvis,
      a.out_cmps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_g(const Args& a, int wpq) {
  if (wpq == 1) return launch_config<T, G, 1>(a);
  if (wpq == 4) return launch_config<T, G, 4>(a);
  return -1;
}

// G, the lanes a row: the 16-byte pieces of a row, as a power of two up to
// 32 (fp32 rows hold 8..64 pieces, bf16 4..32, bytes 2..16).
template <typename T>
int launch(const Args& a, int wpq) {
  const int pieces = a.w * static_cast<int>(sizeof(T)) / 16;
  if constexpr (sizeof(T) == 1) {
    if (pieces < 4) return launch_g<T, 2>(a, wpq);
  }
  if constexpr (sizeof(T) <= 2) {
    if (pieces < 8) return launch_g<T, 4>(a, wpq);
  }
  if (pieces < 16) return launch_g<T, 8>(a, wpq);
  if constexpr (sizeof(T) >= 2) {
    if (pieces >= 32) return launch_g<T, 32>(a, wpq);
  }
  return launch_g<T, 16>(a, wpq);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int8, 3 uint8; wpq: warps per query (a CTA
// a query), 1 or 4. Returns 0 or a CUDA error code; -1 for arguments outside
// the caps.
extern "C" int beam_search_launch(const void* vecs, int dtype, const int* nbrs,
                                  const float* nrms, const float* scale,
                                  const float* queries, const int* starts,
                                  const float* d0, const uint8_t* active, int n_q,
                                  int m, int R, int w, int beam, int limit, int l2,
                                  int wpq, int* out_ids, float* out_d, int* out_nvis,
                                  int* out_cmps, void* stream) {
  if (n_q < 1 || m < 1 || R < 1 || R > MAX_R || w < 32 || w > MAX_W || w % 32 != 0 ||
      beam < 1 || beam > MAX_BEAM)
    return -1;
  const Args a{vecs, nbrs, nrms, scale, queries, starts, d0, active, n_q, m, R, w, beam,
               limit, l2, out_ids, out_d, out_nvis, out_cmps,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch<float>(a, wpq);
    case 1: return launch<uint16_t>(a, wpq);
    case 2: return launch<int8_t>(a, wpq);
    case 3: return launch<uint8_t>(a, wpq);
    default: return -1;
  }
}
