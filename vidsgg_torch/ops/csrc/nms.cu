// Exact greedy NMS over many independent problems, one thread block each,
// scanned in tiles of 32 ranks against a list of the boxes kept so far.
//
// Replaces the TPU kernels vidsgg/ops/pallas_nms.py:206
// (nms_mask_pallas_batched -> _nms_batch_kernel: max_keep, presorted) and
// vidsgg/ops/pallas_nms.py:257 (nms_mask_pallas -> _nms_kernel: ranking
// inside the call, no max_keep), and the XLA loop of
// vidsgg/models/postprocess_device.py:_grouped_nms (a group per box).
//
// Contract, in rank order (score descending, ties by index; where the
// kernel ranks, the key is where(valid, score, fill), as a stable
// torch.sort(descending=True) orders it): box r is kept when it is valid and
// no kept box ranked before it, of the same group when there are groups,
// has IoU (+1 areas) strictly greater than the threshold with it. With
// max_keep > 0 a problem stops at its max_keep-th keep or at its valid
// count, so exactly its first max_keep keeps are marked. Without max_keep
// it stops past its last valid rank.
//
// What bounds it on an H100: neither bytes nor operations. At the RPN call
// (16 problems x 6000 presorted boxes, max_keep 100) the ranks that matter
// are about 176 per problem, some 60 KB and a few hundred thousand IoUs in
// all: well under a microsecond of either. The limit is the tile-serial
// dependency: tile t+1 can be resolved only once tile t's keeps are known.
// The design pays two barriers per 32 ranks, not one per kept box:
//   A. every warp takes a strided slice of the kept list, one candidate of
//      the tile per lane, and ORs the lanes it suppresses into one shared
//      word (one __ballot_sync per warp); the same warps compute the tile's
//      upper-triangular 32 x 32 suppression rows (row j: the later lanes j
//      suppresses), one ballot per row. Barrier.
//   B. warp 0 resolves the tile's greedy order in registers (a
//      __shfl_sync per keep, no barrier), caps it at max_keep, marks the
//      keeps and appends them to the kept list at __popc offsets. Barrier.
// Only the tiles the scan reaches are read: while a tile is resolved, the
// last warp stages the next one (coordinates, groups) into a second buffer
// with cp.async, so the RPN call reads about 6 tiles of its 188 and nothing
// of the problem is staged whole. Shared memory holds the kept list
// (max_keep boxes, or N without max_keep) and, where the kernel ranks
// (N <= 1024), the sort keys; the wrapper refuses what does not fit.
//
// Ranking inside the kernel: one bitonic sort per block over (key, index)
// pairs, keys as order-preserving unsigned integers (+0 and -0 as one key,
// as torch.sort ties them), so the order is exactly the stable sort's. It
// takes the wrapper's sort, gathers and scatter off the class-grid call.
//
// Bit-exactness with the plain PyTorch version and with vidsgg: IoU in the
// boxes' type (float32, float64 for the grouped call in a float64 model, or
// bfloat16 for the grouped call in bfloat16 serving) in the reference order
// with explicit round-to-nearest intrinsics, built with -fmad=false (no
// contraction), IEEE division; the threshold arrives in the same type, and a
// box whose IoU equals it is not suppressed:
//   area  = (x2 - x1 + 1) * (y2 - y1 + 1)
//   iw    = min(x2, xk2) - max(x1, xk1) + 1   (ih likewise)
//   inter = max(iw, 0) * max(ih, 0)
//   iou   = inter / (area + area_k - inter)
//
// The bfloat16 route (Bf16 below) stores boxes, scores and the kept list as
// 16-bit values, and computes every operation above in float32 with the _rn
// intrinsics, then rounds it to bfloat16 (nearest even) before the next one:
// the per-operation rounding of torch's bfloat16 kernels and of XLA's. min
// and max are exact. The comparison with the threshold (bfloat16(0.6) =
// 0.6015625, rounded on the host) and the ranking keys use the exact
// float32 upcast. A row is 8 bytes, so a lane stages it with one 8-byte
// cp.async where a float32 row takes one 16-byte copy and a float64 row two.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kMaxRanked = 1024;   // largest N the kernel ranks itself
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }

// bfloat16 round to nearest even from float32 bits (NaN stays a quiet NaN),
// as c10::BFloat16 and __float2bfloat16_rn round
__host__ __device__ inline unsigned short bf16_bits_rn(unsigned u) {
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<unsigned short>((u >> 16) | 0x40u);
  return static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// A bfloat16 value: 16 bits of storage, arithmetic in float32 and one
// rounding per operation.
struct Bf16 {
  unsigned short bits;
  Bf16() = default;
  // host and device: an exact conversion for values bfloat16 holds (the
  // threshold and the fill arrive as such), round to nearest even otherwise
  __host__ __device__ explicit Bf16(double x) {
    const float f = static_cast<float>(x);
    unsigned u;
    memcpy(&u, &f, sizeof(u));
    bits = bf16_bits_rn(u);
  }
  __device__ __forceinline__ float up() const { return __uint_as_float(static_cast<unsigned>(bits) << 16); }
  __device__ __forceinline__ static Bf16 rn(float f) {
    Bf16 r;
    r.bits = bf16_bits_rn(__float_as_uint(f));
    return r;
  }
};

__device__ __forceinline__ Bf16 add_rn(Bf16 a, Bf16 b) { return Bf16::rn(__fadd_rn(a.up(), b.up())); }
__device__ __forceinline__ Bf16 sub_rn(Bf16 a, Bf16 b) { return Bf16::rn(__fsub_rn(a.up(), b.up())); }
__device__ __forceinline__ Bf16 mul_rn(Bf16 a, Bf16 b) { return Bf16::rn(__fmul_rn(a.up(), b.up())); }
__device__ __forceinline__ Bf16 div_rn(Bf16 a, Bf16 b) { return Bf16::rn(__fdiv_rn(a.up(), b.up())); }
__device__ __forceinline__ Bf16 min_(Bf16 a, Bf16 b) { return Bf16::rn(fminf(a.up(), b.up())); }
__device__ __forceinline__ Bf16 max_(Bf16 a, Bf16 b) { return Bf16::rn(fmaxf(a.up(), b.up())); }
__device__ __forceinline__ bool operator>(Bf16 a, Bf16 b) { return a.up() > b.up(); }

// order-preserving unsigned key: a > b  <=>  key(a) > key(b); +0 == -0
__device__ __forceinline__ unsigned long long order_key(float x) {
  unsigned b = x == 0.0f ? 0u : __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ unsigned long long order_key(double x) {
  unsigned long long b =
      x == 0.0 ? 0ull : static_cast<unsigned long long>(__double_as_longlong(x));
  return (b >> 63) ? ~b : (b | (1ull << 63));
}
__device__ __forceinline__ unsigned long long order_key(Bf16 x) { return order_key(x.up()); }

template <typename T>
struct Box {
  T x1, y1, x2, y2, area;
};

template <typename T>
__device__ __forceinline__ Box<T> load_box(const T* p) {
  Box<T> b{p[0], p[1], p[2], p[3], T(0)};
  b.area = mul_rn(add_rn(sub_rn(b.x2, b.x1), T(1)), add_rn(sub_rn(b.y2, b.y1), T(1)));
  return b;
}

// IoU of candidate c with an earlier box k, in the reference's order
template <typename T>
__device__ __forceinline__ T iou(const Box<T>& c, const Box<T>& k) {
  const T iw = add_rn(sub_rn(min_(c.x2, k.x2), max_(c.x1, k.x1)), T(1));
  const T ih = add_rn(sub_rn(min_(c.y2, k.y2), max_(c.y1, k.y1)), T(1));
  const T inter = mul_rn(max_(iw, T(0)), max_(ih, T(0)));
  return div_rn(inter, sub_rn(add_rn(c.area, k.area), inter));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__host__ __device__ inline size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

__host__ __device__ inline int ranked_width(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory, in bytes from a 16-byte aligned base:
//   tile boxes [2][32][4] T | kept boxes [cap][4] T | kept areas [cap] T |
//   tile groups [2][32] i64 | kept groups [cap] i64   (with groups) |
//   sort keys [P] u64 | sort indices [P] i32 | valid [N] u8  (when ranked)
struct Layout {
  size_t tile_box, kept_box, kept_area, tile_group, kept_group, key, idx, valid, total;
};

__host__ __device__ inline Layout make_layout(size_t item, int n, int max_keep, bool grouped,
                                              bool ranked) {
  const size_t cap = (max_keep > 0 && max_keep < n) ? max_keep : n;
  const size_t p = ranked ? ranked_width(n) : 0;
  Layout l;
  size_t off = 0;
  l.tile_box = off;   off += 2 * kTile * 4 * item;
  l.kept_box = off;   off += cap * 4 * item;
  l.kept_area = off;  off += cap * item;
  off = align_up(off, 8);
  l.tile_group = off; off += grouped ? 2 * kTile * 8 : 0;
  l.kept_group = off; off += grouped ? cap * 8 : 0;
  l.key = off;        off += p * 8;
  l.idx = off;        off += p * 4;
  l.valid = off;      off += ranked ? n : 0;
  l.total = align_up(off, 16);
  return l;
}

// One lane stages rank r of a tile: the box's row (and group) with
// cp.async, or zeros past the problem's end.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, long long* dst_group, const T* boxes,
                                          const long long* group, size_t base,
                                          const int* order, int r, int n) {
  if (r < n) {
    const size_t i = base + (order ? order[r] : r);
    const T* src = boxes + 4 * i;
    if (sizeof(T) == 2) {
      cp_async8(dst, src);
    } else {
      cp_async16(dst, src);
      if (sizeof(T) == 8) cp_async16(dst + 2, src + 2);
    }
    if (group) cp_async8(dst_group, group + i);
  } else {
    dst[0] = dst[1] = dst[2] = dst[3] = T(0);
    if (group) *dst_group = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nms_tile_kernel(const T* __restrict__ boxes,            // [G, N, 4]
                const T* __restrict__ scores,           // [G, N], null: presorted
                const unsigned char* __restrict__ valid,  // [G, N]
                const long long* __restrict__ group,    // [G, N], null: one group
                unsigned char* __restrict__ keep,       // [G, N], input order
                int* __restrict__ rank_out,             // [G, N] or null
                int n, T thresh, T fill, int max_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_sup;
  __shared__ unsigned s_row[kTile];
  __shared__ int s_kept, s_vcount, s_last;

  const bool ranked = scores != nullptr;
  const bool grouped = group != nullptr;
  const Layout lay = make_layout(sizeof(T), n, max_keep, grouped, ranked);
  T* tile_box = reinterpret_cast<T*>(smem + lay.tile_box);
  T* kept_box = reinterpret_cast<T*>(smem + lay.kept_box);
  T* kept_area = reinterpret_cast<T*>(smem + lay.kept_area);
  long long* tile_group = reinterpret_cast<long long*>(smem + lay.tile_group);
  long long* kept_group = reinterpret_cast<long long*>(smem + lay.kept_group);
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem + lay.key);
  int* sidx = reinterpret_cast<int*>(smem + lay.idx);
  unsigned char* svalid = smem + lay.valid;
  const int* order = ranked ? sidx : nullptr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  if (tid == 0) {
    s_sup = 0;
    s_kept = 0;
    s_vcount = 0;
    s_last = -1;
  }
  // the presorted scan's first tile needs no ranking: start its copy now
  if (!ranked && warp == kWarps - 1) {
    stage_row(tile_box + 4 * lane, tile_group + lane, boxes, group, base, order, lane, n);
    cp_async_commit();
  }

  // zero the mask; count the valid boxes (and, presorted, find the last)
  int vcount = 0, last = -1;
  const int p = ranked ? ranked_width(n) : n;
  for (int i = tid; i < p; i += kThreads) {
    if (i < n) {
      const unsigned char v = valid[base + i] != 0;
      keep[base + i] = 0;
      vcount += v;
      if (v) last = i;
      if (ranked) {
        svalid[i] = v;
        skey[i] = order_key(v ? scores[base + i] : fill);
      }
    } else {
      skey[i] = 0;  // padding: the lowest key, and an index past every box
    }
    if (ranked) sidx[i] = i;
  }
  __syncthreads();  // the scalars above are set before the atomics
  atomicAdd(&s_vcount, vcount);
  if (!ranked) atomicMax(&s_last, last);

  if (ranked) {
    // bitonic sort: position i before position j when its key is larger,
    // or equal with the smaller index (a total order: the stable sort's)
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        __syncthreads();
        for (int i = tid; i < p; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj <= i) continue;
          const unsigned long long ka = skey[i], kb = skey[ixj];
          const int ia = sidx[i], ib = sidx[ixj];
          const bool b_first = kb > ka || (kb == ka && ib < ia);
          const bool a_first = ka > kb || (ka == kb && ia < ib);
          if ((i & k) == 0 ? b_first : a_first) {
            skey[i] = kb;
            skey[ixj] = ka;
            sidx[i] = ib;
            sidx[ixj] = ia;
          }
        }
      }
    }
    __syncthreads();
    int last_rank = -1;
    for (int r = tid; r < n; r += kThreads) {
      const int i = sidx[r];
      if (rank_out) rank_out[base + i] = r;
      if (svalid[i]) last_rank = r;
    }
    atomicMax(&s_last, last_rank);
    if (warp == kWarps - 1) {
      stage_row(tile_box + 4 * lane, tile_group + lane, boxes, group, base, order, lane, n);
      cp_async_commit();
    }
  }
  if (warp == kWarps - 1) cp_async_wait_all();
  __syncthreads();

  const int end = max_keep > 0 ? s_vcount : s_last + 1;
  int cur = 0;
  for (int t0 = 0; t0 < end; t0 += kTile, cur ^= 1) {
    const int kept = s_kept;
    if (warp == kWarps - 1 && t0 + kTile < end) {
      const int nxt = (cur ^ 1) * kTile + lane;
      stage_row(tile_box + 4 * nxt, tile_group + nxt, boxes, group, base, order,
                t0 + kTile + lane, n);
      cp_async_commit();
    }

    // A. suppression from the kept list, and the tile's own rows
    const T* tb = tile_box + 4 * cur * kTile;
    const Box<T> c = load_box(tb + 4 * lane);
    const long long cg = grouped ? tile_group[cur * kTile + lane] : 0;
    bool sup = false;
    for (int k = warp; k < kept; k += kWarps) {
      if (grouped && kept_group[k] != cg) continue;
      const T* kb = kept_box + 4 * k;
      const Box<T> kbox{kb[0], kb[1], kb[2], kb[3], kept_area[k]};
      sup |= iou(c, kbox) > thresh;
    }
    const unsigned sup_mask = __ballot_sync(kFull, sup);
    if (lane == 0 && sup_mask) atomicOr(&s_sup, sup_mask);
    for (int j = warp; j < kTile; j += kWarps) {
      bool hit = false;
      if (lane > j && (!grouped || tile_group[cur * kTile + j] == cg)) {
        hit = iou(c, load_box(tb + 4 * j)) > thresh;
      }
      const unsigned row = __ballot_sync(kFull, hit);
      if (lane == 0) s_row[j] = row;
    }
    __syncthreads();

    // B. resolve the tile in rank order, in warp 0's registers
    if (warp == 0) {
      const int r = t0 + lane;
      int src = r;
      bool v = false;
      if (r < end) {
        src = ranked ? sidx[r] : r;
        v = ranked ? svalid[src] != 0 : valid[base + r] != 0;
      }
      unsigned alive = __ballot_sync(kFull, v) & ~s_sup;
      const unsigned row = s_row[lane];
      __syncwarp();
      if (lane == 0) s_sup = 0;
      int budget = max_keep > 0 ? max_keep - kept : kTile;
      unsigned kept_mask = 0;
      while (alive && budget > 0) {  // alive is the same in every lane
        const int i = __ffs(alive) - 1;
        kept_mask |= 1u << i;
        alive &= ~(1u << i) & ~__shfl_sync(kFull, row, i);
        --budget;
      }
      if ((kept_mask >> lane) & 1u) {
        keep[base + src] = 1;
        const int slot = kept + __popc(kept_mask & ((1u << lane) - 1u));
        T* kb = kept_box + 4 * slot;
        kb[0] = c.x1;
        kb[1] = c.y1;
        kb[2] = c.x2;
        kb[3] = c.y2;
        kept_area[slot] = c.area;
        if (grouped) kept_group[slot] = cg;
      }
      if (lane == 0) s_kept = kept + __popc(kept_mask);
    }
    if (warp == kWarps - 1) cp_async_wait_all();
    __syncthreads();
    if (max_keep > 0 && s_kept >= max_keep) break;
  }
}

template <typename T>
int launch(const void* boxes, const void* scores, const unsigned char* valid,
           const long long* group, unsigned char* keep, int* rank, int g, int n,
           double thresh, double fill, int max_keep, cudaStream_t stream) {
  const bool ranked = scores != nullptr;
  if (ranked && n > kMaxRanked) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = make_layout(sizeof(T), n, max_keep, group != nullptr, ranked).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_tile_kernel<T><<<g, kThreads, smem, stream>>>(
      static_cast<const T*>(boxes), static_cast<const T*>(scores), valid, group, keep, rank, n,
      static_cast<T>(thresh), static_cast<T>(fill), max_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (item: 2 for bfloat16, 4 for float32,
// 8 for float64).
long long vidsgg_nms_smem_bytes(int item, int n, int max_keep, int grouped, int ranked) {
  return static_cast<long long>(
      make_layout(static_cast<size_t>(item), n, max_keep, grouped != 0, ranked != 0).total);
}

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// scores null: the boxes are in rank order; otherwise the kernel ranks them
// (n <= 1024) and, when rank is not null, writes each
// box's rank. group null: one group. Boxes 16-byte aligned, group 8-byte.
int vidsgg_nms_launch(int item, const void* boxes, const void* scores,
                      const unsigned char* valid, const long long* group, unsigned char* keep,
                      int* rank, int g, int n, double thresh, double fill, int max_keep,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (item == 4)
    return launch<float>(boxes, scores, valid, group, keep, rank, g, n, thresh, fill, max_keep, s);
  if (item == 8)
    return launch<double>(boxes, scores, valid, group, keep, rank, g, n, thresh, fill, max_keep, s);
  if (item == 2)
    return launch<Bf16>(boxes, scores, valid, group, keep, rank, g, n, thresh, fill, max_keep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* vidsgg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
