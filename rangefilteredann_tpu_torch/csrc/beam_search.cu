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
// Bound on an H100 SXM. A step reads the expanded node's R ids and norms
// and the rows of its [R, w] block, and does 2 * w flops a row scored: about
// 1/2 flop per fp32 byte, far below the card's balance point, so a full
// launch is bound by the bytes it reads once enough steps are in flight, and
// a launch of few queries by the latency of one step. Measured on the card
// (PERF.md): with the whole block of each expansion in flight (24,960 bytes
// at R = 48, w = 128 fp32) the full launches read ~2 TB/s of expansion
// bytes and more queries an SM gained nothing, so the step's bytes set the
// pace; yet about three quarters of a step's candidates are ids the same
// search has already scored.
//
// What the design does about it:
//   * Only the rows a search has not scored. Each query keeps a table of the
//     ids it has scored from blocks in this launch: a direct-mapped array in
//     shared memory (TABLE_PER_BEAM x beam slots, a power of two, each the
//     16-bit tag of an id whose slot gives the rest of it, or the whole id
//     where tags would not fit; a new id overwrites its slot, so the table
//     forgets and never invents). Skipping such an id gives the same
//     frontier: its distance does not depend on the block (below), and the
//     tail distance never rises, so an id scored before either sits in the
//     frontier, where the duplicate test drops it, or was refused or evicted
//     at a distance >= the tail of that time >= today's tail, and admission
//     needs strictly below. A skipped candidate still counts in cmps. The
//     start id is never entered: its d0 comes from the full store row. Int8
//     blocks with a per-node scale quantize per owner node, so there the
//     table is off and each step stages the whole block, as below with
//     every row unseen.
//   * Ids first, then the unseen rows, fetched while merging. As soon as the
//     candidates are known, the next node is the smaller, in (dist, id)
//     order, of the first unexplored old slot after the expanded one and
//     the best surviving candidate. Its R ids and norms arrive by cp.async;
//     each valid id the table lacks gets one bulk copy of the tensor memory
//     accelerator (cp.async.bulk of its row, completing on the step's
//     mbarrier, which expects the sum of their bytes), compacted in row
//     order into a staging buffer, before the merge; the next step waits for
//     them only if the merge was shorter. In the one-warp configuration the
//     buffer holds STAGE_BYTES, and a step with more such rows (the first
//     steps of a search) stages the rest in further chunks, each once the
//     last is scored; in the four-warp one it holds a block. Without the
//     table the whole block, which fits, is one bulk copy issued with the
//     ids. (Measured on the card, PERF.md: the bulk copy was a little faster
//     than 16-byte cp.async by lane, and staging cut ~20% from register
//     loads with an L2 prefetch.)
//   * Distances from shared memory: G lanes (G = 16-byte pieces of a row, up
//     to 32) read one staged row, lane g the pieces g, g + G, ... Each lane
//     keeps one partial sum per row it touched (an FMA chain over its pieces
//     in column order); a butterfly over the G lanes (G - 1 shuffles for G
//     rows) leaves each lane one row's sum. The summation tree is the same
//     for every row and every staged position, so a node's distance does not
//     depend on the block, the rows staged beside it or the configuration
//     that computed it.
//   * A parallel merge. One pass a step: the admitted candidates are
//     compacted in candidate order and tested, threads over the frontier's
//     slots and the admitted, against every frontier id and every earlier
//     admitted id; each survivor finds its place by a binary search in the
//     sorted frontier plus its rank among the survivors. The frontier then
//     moves in place, top chunk first, each slot up by the survivors ahead
//     of it, and the survivors drop into their places; the next slot to
//     expand is known already, so no scan selects it.
//   * One CTA per query, in two configurations of one kernel template: one
//     warp, for batches that fill the card (a query's state, its staging
//     buffer and table included, is ~22 KB at R = 64, w = 128 fp32 and beam
//     80, so an SM holds 9; 5 at beam 640); and four warps for small
//     batches, which split the rows, the duplicate test and the moves. The
//     wrapper picks by a rule on the batch (ops/beam.py launch_config). The
//     hardware hands a finished CTA's SM to the next query, so no query
//     waits for another.
// State per query in shared memory: control words, the query (4 bytes a
// column), the candidates' scratch (CAND_ARRAYS x MAX_R words), the table
// of scored ids (2 or 4 bytes a slot), the staging buffer (stage_rows x w x
// elem bytes), the frontier (dist, id, explored flag: 9 bytes a slot). Each
// query also returns the rows it scored (out_scored), which the wrapper sums
// for the port's tracing.
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
constexpr int CTL_BYTES = 48;     // per-query control words
constexpr int CAND_ARRAYS = 12;   // candidate scratch arrays of MAX_R words
constexpr int TABLE_PER_BEAM = 8; // slots of the table of scored ids a frontier slot
constexpr int STAGE_BYTES = 16384;  // the staging buffer, at most (a whole block if smaller)
constexpr unsigned FULL = 0xffffffffu;

// log2 of the table's slots: the least power of two >= TABLE_PER_BEAM x
// beam, or 0 (no table) for blocks with a per-node scale.
__host__ __device__ __forceinline__ int table_bits(int beam, bool scaled) {
  if (scaled) return 0;
  int b = 0;
  while ((1 << b) < TABLE_PER_BEAM * beam) ++b;
  return b;
}

// Whether the table holds whole ids (4 bytes a slot) rather than 16-bit
// tags: when some id of the m nodes has a tag of 0xffff or more.
__host__ __device__ __forceinline__ bool table_wide(int tbits, int m) {
  return tbits > 0 && ((m - 1) >> tbits) >= 0xffff;
}

// Rows the staging buffer holds: a whole block (R rows), up to STAGE_BYTES
// in the one-warp configuration, whose CTAs share the SMs (in the four-warp
// one every query's CTA is resident, so a smaller buffer would only add
// chunks to a step).
__host__ __device__ __forceinline__ int stage_rows(int R, int w, size_t elem, int wpq) {
  const int fit = static_cast<int>(STAGE_BYTES / (static_cast<size_t>(w) * elem));
  return wpq != 1 || R < fit ? R : fit;
}

__host__ __device__ __forceinline__ size_t query_smem_bytes(int beam, int R, int w, size_t elem,
                                                            int tbits, bool wide, int wpq) {
  return (static_cast<size_t>(CTL_BYTES) + static_cast<size_t>(w) * 4 +
          static_cast<size_t>(CAND_ARRAYS) * MAX_R * 4 +
          (tbits > 0 ? static_cast<size_t>(wide ? 4 : 2) << tbits : 0) +
          static_cast<size_t>(stage_rows(R, w, elem, wpq)) * w * elem +
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
                  // [6..7] the staging's mbarrier, [8] rows to stage, [9] the
                  // staged node
  float* qs;      // [w] the query
  float* cd;      // [MAX_R] candidate distances, by staged row
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
  int* srow;      // [MAX_R] the block row of each row to stage, in order
  void* seen;     // [1 << tbits] the table of scored ids (seen_has)
  unsigned char* blk;  // [stage_rows x w x elem] the staged rows, compacted
  float* fd;      // [beam] the frontier
  int* fid;
  uint8_t* fe;    // [beam] explored flags

  __device__ QueryState(unsigned char* base, int beam, int w, int blk_bytes, int seen_bytes) {
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
    srow = reinterpret_cast<int*>(bnrm + MAX_R);
    seen = srow + MAX_R;
    blk = reinterpret_cast<unsigned char*>(seen) + seen_bytes;  // 16-byte aligned
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
// The step's one arrival on the mbarrier, expecting `bytes` of bulk copies.
__device__ __forceinline__ void stage_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void stage_bulk(void* dst, const void* src, unsigned bytes,
                                           void* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after the reads of dst
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

// The table of scored ids: 1 << tbits slots. An id's slot is its low tbits
// bits XOR a hash of its tag, the bits above them, so slot and tag give the
// id back: a slot holds the tag (16 bits, 0xffff empty) or, where tags do
// not fit (table_wide), the whole id (-1 empty).
__device__ __forceinline__ int seen_slot(int id, int tbits) {
  const unsigned u = static_cast<unsigned>(id);
  return static_cast<int>((u ^ (((u >> tbits) * 0x9E3779B1u) >> (32 - tbits))) &
                          ((1u << tbits) - 1u));
}
__device__ __forceinline__ bool seen_has(const QueryState& st, int id, int tbits, bool wide) {
  const int k = seen_slot(id, tbits);
  return wide ? static_cast<const int*>(st.seen)[k] == id
              : static_cast<const uint16_t*>(st.seen)[k] == (static_cast<unsigned>(id) >> tbits);
}
__device__ __forceinline__ void seen_add(const QueryState& st, int id, int tbits, bool wide) {
  const int k = seen_slot(id, tbits);
  if (wide) {
    static_cast<int*>(st.seen)[k] = id;
  } else {
    static_cast<uint16_t*>(st.seen)[k] = static_cast<uint16_t>(static_cast<unsigned>(id) >> tbits);
  }
}

// One warp issues the bulk copies of the rows to stage [k0, k1) of the
// staged node (srow, ctl[9]) into the staging buffer from its start: the
// step's arrival on the mbarrier, expecting their bytes, then one copy a
// row.
template <typename T>
__device__ __forceinline__ void stage_chunk(const QueryState& st, const T* vecs, int R, int w,
                                            int k0, int k1, int lane) {
  const unsigned row_bytes = static_cast<unsigned>(w * sizeof(T));
  const size_t base = static_cast<size_t>(st.ctl[9]) * R;
  if (lane == 0) stage_expect(st.ctl + 6, (k1 - k0) * row_bytes);
  __syncwarp();
  for (int k = k0 + lane; k < k1; k += 32)
    stage_bulk(st.blk + static_cast<size_t>(k - k0) * row_bytes, vecs + (base + st.srow[k]) * w,
               row_bytes, st.ctl + 6);
}

// One warp stages a node into the query's state: its ids, norms and scale,
// and of its block either every row (tbits == 0, no table: one bulk copy;
// srow and ctl[8] keep the identity set at the start) or each row whose id
// is valid and missing from the table, compacted in row order once the ids
// have arrived (srow and ctl[8] say which), of which the first chunk that
// the buffer holds is copied now.
template <typename T>
__device__ __forceinline__ void stage_node(const QueryState& st, const T* vecs, const int* nbrs,
                                           const float* nrms, const float* scale, int node,
                                           int R, int w, int srows, int tbits, bool wide,
                                           int lane) {
  const size_t base = static_cast<size_t>(node) * R;
  if (tbits == 0 && lane == 0) {
    const unsigned bytes = static_cast<unsigned>(R * w * sizeof(T));
    stage_expect(st.ctl + 6, bytes);
    stage_bulk(st.blk, vecs + base * w, bytes, st.ctl + 6);
  }
  for (int j = lane; j < R; j += 32) {
    stage4(st.bid + j, nbrs + base + j);
    stage4(st.bnrm + j, nrms + base + j);
  }
  if (lane == 0 && scale != nullptr) stage4(st.ctl + 5, scale + node);
  if (tbits == 0) return;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  int n = 0;
  for (int j0 = 0; j0 < R; j0 += 32) {
    const int j = j0 + lane;
    const int id = j < R ? st.bid[j] : -1;
    const bool need = id >= 0 && !seen_has(st, id, tbits, wide);
    const unsigned nb = __ballot_sync(FULL, need);
    if (need) st.srow[n + __popc(nb & lt)] = j;
    n += __popc(nb);
  }
  if (lane == 0) {
    st.ctl[8] = n;
    st.ctl[9] = node;
  }
  __syncwarp();
  stage_chunk(st, vecs, R, w, 0, min(n, srows), lane);
}

// The candidates of the n rows in the staging buffer, rows k0.. of the
// rows to stage: distances into cd, ids into cid, from k0 on. Warp wq of
// the query's WPQ warps takes the row rounds wq, wq + WPQ, ...; a round is
// 32 / G rows, one per group of G lanes.
template <typename T, int G, int WPQ>
__device__ __forceinline__ void candidate_distances(bool scaled, int l2, int k0, int n, int w,
                                                    int wq, int lane, const QueryState& st) {
  using P = Piece<T>;
  constexpr int RPR = 32 / G;           // rows a round
  constexpr int LD = G < 16 ? G : 16;   // loads in flight a lane
  const int pieces = w * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces a row
  const int ppl = (pieces + G - 1) / G;
  const int grp = lane / G, g = lane % G;
  const int rounds = (n + RPR - 1) / RPR;
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
          ok[t] = row < n && pc < pieces;
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
    if (my_row < n) {
      float acc = part[0];
      if (scaled) acc = sc * acc;
      const int j = st.srow[k0 + my_row];
      const int id = st.bid[j];
      const bool valid = id >= 0;
      st.cd[k0 + my_row] = valid ? (l2 ? st.bnrm[j] - 2.f * acc : -acc) : INFINITY;
      st.cid[k0 + my_row] = valid ? id : EMPTY_ID;
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
                   int m, int R, int w, int beam, int limit, int l2, int tbits, int wide,
                   int* __restrict__ out_ids,         // [Q, beam]
                   float* __restrict__ out_d,         // [Q, beam]
                   int* __restrict__ out_nvis,        // [Q]
                   int* __restrict__ out_cmps,        // [Q]
                   int* __restrict__ out_scored) {    // [Q]
  constexpr int NT = 32 * WPQ;  // the query's threads: the CTA
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wq = tid >> 5;  // warp 0 steers
  const int q = blockIdx.x;
  const int srows = stage_rows(R, w, sizeof(T), WPQ);
  const int seen_bytes = tbits > 0 ? (wide ? 4 : 2) << tbits : 0;
  const QueryState st(smem, beam, w, srows * w * static_cast<int>(sizeof(T)), seen_bytes);
  const unsigned lt = (1u << lane) - 1u;

  for (int i = tid; i < beam; i += NT) {
    st.fd[i] = INFINITY;
    st.fid[i] = EMPTY_ID;
    st.fe[i] = 0;
  }
  for (int i = tid; i < w; i += NT) st.qs[i] = queries[static_cast<size_t>(q) * w + i];
  for (int i = tid; i < seen_bytes / 4; i += NT) static_cast<int*>(st.seen)[i] = -1;  // all empty
  if (tbits == 0) {  // every row staged, in place
    for (int i = tid; i < R; i += NT) st.srow[i] = i;
    if (tid == 0) st.ctl[8] = R;
  }
  if (tid == 0) bar_init(st.ctl + 6);
  group_sync<WPQ>();
  const bool act = active[q] != 0;
  const int start = starts[q];  // never entered in the table: its d0 is the store row's
  int s = act && limit > 0 ? 0 : -1;  // the slot to expand
  if (act && wq == 0) {
    if (lane == 0) {
      st.fd[0] = d0[q];
      st.fid[0] = start;
    }
    if (s == 0)
      stage_node(st, vecs, nbrs, nrms, scale, min(max(start, 0), m - 1), R, w, srows, tbits,
                 wide, lane);
  }
  int n_vis = 0, cmps = act ? 1 : 0;  // cmps and scored are kept by warp 0
  int scored = 0;
  unsigned phase = 0;  // of the mbarrier: one arrival a chunk staged
  int fill = act ? 1 : 0;             // slots [0, fill) hold nodes

  while (s >= 0) {
    // --- the candidates of the expanded node, whose rows are staged ---
    // (chunk by chunk where the buffer holds fewer rows than there are)
    ++n_vis;
    int n_st = 0;
    for (int k0 = 0;; k0 += srows) {
      stage_wait(st.ctl + 6, phase++ & 1);
      group_sync<WPQ>();
      n_st = st.ctl[8];
      candidate_distances<T, G, WPQ>(scale != nullptr, l2, k0, min(n_st - k0, srows), w, wq,
                                     lane, st);
      group_sync<WPQ>();
      if (k0 + srows >= n_st) break;
      if (wq == 0) stage_chunk(st, vecs, R, w, k0 + srows, min(n_st, k0 + 2 * srows), lane);
    }

    // --- admit below the pre-step tail, compacted in candidate order; every
    // valid id counts in cmps, the staged ones in scored and the table ---
    if (wq == 0) {
      const float tail = st.fd[beam - 1];
      for (int j0 = 0; j0 < R; j0 += 32)
        cmps += __popc(__ballot_sync(FULL, j0 + lane < R && st.bid[j0 + lane] >= 0));
      int n_k = 0;
      for (int j0 = 0; j0 < n_st; j0 += 32) {
        const int j = j0 + lane;
        const int id = j < n_st ? st.cid[j] : EMPTY_ID;
        const float d = j < n_st ? st.cd[j] : INFINITY;
        scored += __popc(__ballot_sync(FULL, id != EMPTY_ID));
        if (tbits > 0 && id != EMPTY_ID && id != start) seen_add(st, id, tbits, wide);
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

    // --- the survivors' places, the next slot to expand, and its rows
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
        stage_node(st, vecs, nbrs, nrms, scale, min(next_node, m - 1), R, w, srows, tbits, wide,
                   lane);
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
    out_scored[q] = scored;
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
  int* out_scored;
  cudaStream_t stream;
};

template <typename T, int G, int WPQ>
int launch_config(const Args& a) {
  const int tbits = table_bits(a.beam, a.scale != nullptr);
  const bool wide = table_wide(tbits, a.m);
  const size_t smem = query_smem_bytes(a.beam, a.R, a.w, sizeof(T), tbits, wide, WPQ);
  auto kernel = beam_search_kernel<T, G, WPQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_q, 32 * WPQ, smem, a.stream>>>(
      static_cast<const T*>(a.vecs), a.nbrs, a.nrms, a.scale, a.queries, a.starts, a.d0,
      a.active, a.m, a.R, a.w, a.beam, a.limit, a.l2, tbits, static_cast<int>(wide), a.out_ids,
      a.out_d, a.out_nvis, a.out_cmps, a.out_scored);
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
// a query), 1 or 4; out_scored: each query's rows scored. Returns 0 or a CUDA
// error code; -1 for arguments outside the caps.
extern "C" int beam_search_launch(const void* vecs, int dtype, const int* nbrs,
                                  const float* nrms, const float* scale,
                                  const float* queries, const int* starts,
                                  const float* d0, const uint8_t* active, int n_q,
                                  int m, int R, int w, int beam, int limit, int l2,
                                  int wpq, int* out_ids, float* out_d, int* out_nvis,
                                  int* out_cmps, int* out_scored, void* stream) {
  if (n_q < 1 || m < 1 || R < 1 || R > MAX_R || w < 32 || w > MAX_W || w % 32 != 0 ||
      beam < 1 || beam > MAX_BEAM || (scale != nullptr && dtype != 2))
    return -1;
  const Args a{vecs, nbrs, nrms, scale, queries, starts, d0, active, n_q, m, R, w, beam,
               limit, l2, out_ids, out_d, out_nvis, out_cmps, out_scored,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch<float>(a, wpq);
    case 1: return launch<uint16_t>(a, wpq);
    case 2: return launch<int8_t>(a, wpq);
    case 3: return launch<uint8_t>(a, wpq);
    default: return -1;
  }
}
