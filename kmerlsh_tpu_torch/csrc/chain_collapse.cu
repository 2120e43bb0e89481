// K3 (with the K4 parent fold): single-pass chain collapse over the sorted
// state.
//
// Replaces kmerlsh_tpu/cluster/engine.py chain_collapse (with _seg_scan,
// _rev_fill and segment.segment_starts) and the per-program parent fold of
// _iterate_update (engine.py:553). In sorted order: a position links to the
// previous one when both are alive, share a bucket (key >> free_bits), the
// position is not a multiple of 2^15 (the reference's stride cut) and their
// cosine reaches the threshold. Each chain collapses onto its LAST position:
// size = the chain's total, value = the size-weighted mean, slot = the
// head's slot; the last position's own slot moves to the head position. Every
// other member dies: merged_into = head slot, and parent[slot] = head slot.
// Each slot dies once, so writing parent here equals the reference's fold.
//
// Bound on the H100: device-memory bandwidth (the [S, M] values are read
// about three times and written once). The stride cut means no chain crosses
// an aligned 32768-position tile, so one block owns one tile and needs no
// carry from any other block, no look-back. Inside a block:
//   1. link flags for the tile into shared memory (thread i, i + T, ...:
//      coalesced column reads); the cosine is summed s = 0, 1, ... with
//      separately rounded operations, as the plain version does, so the
//      links agree bit for bit;
//   2. each thread scans its contiguous chunk of the tile from an empty
//      state and leaves its end state (last head, size sum, value sums);
//   3. S + 1 threads turn those into exclusive carries, one lane each;
//   4. each thread rescans its chunk from its carry and writes the outputs.
// The sums therefore run in chunk order, not in the reference's log-step
// order: centroids agree with the plain version to rounding, not bit for bit.

#include "common.cuh"

#define KL_TILE 32768

__device__ __forceinline__ bool kl_alive(int size, int key) {
  return size > 0 && key != KL_BIG_KEY;
}

__global__ void kl_chain_kernel(const float* __restrict__ sv, int S, long long M,
                                const int* __restrict__ ssize,
                                const int* __restrict__ sslot,
                                const int* __restrict__ skey,
                                const int* __restrict__ smi, float thr,
                                int free_bits, float* __restrict__ out_v,
                                int* __restrict__ out_size,
                                int* __restrict__ out_slot,
                                int* __restrict__ out_mi,
                                int* __restrict__ parent) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  unsigned char* flags = smem;                       // bit 1 alive, bit 0 link
  int* agg_head = (int*)(smem + KL_TILE);            // [T] last head in chunk
  int* agg_w = agg_head + T;                         // [T] size sum -> carry
  int* carry_head = agg_w + T;                       // [T]
  float* agg_v = (float*)(carry_head + T);           // [S][T] -> carry
  const long long base = (long long)blockIdx.x * KL_TILE;
  const int len = (int)min((long long)KL_TILE, M - base);

  // 1. alive and link flags
  for (int i = t; i < len; i += T) {
    long long p = base + i;
    int k = skey[p];
    bool alive = kl_alive(ssize[p], k);
    bool link = false;
    if (alive && i > 0) {   // i == 0 is a multiple of 2^15: never linked
      int kq = skey[p - 1];
      if (kl_alive(ssize[p - 1], kq) && (k >> free_bits) == (kq >> free_bits)) {
        float dot = 0.f, na = 0.f, nb = 0.f;
        for (int s = 0; s < S; ++s) {
          float a = sv[(long long)s * M + p];
          float b = sv[(long long)s * M + p - 1];
          dot = __fadd_rn(dot, __fmul_rn(a, b));
          na = __fadd_rn(na, __fmul_rn(a, a));
          nb = __fadd_rn(nb, __fmul_rn(b, b));
        }
        float nn = __fsqrt_rn(__fmul_rn(na, nb));
        float sim = __fdiv_rn(dot, nn > 0.f ? nn : 1.f);
        link = sim >= thr;
      }
    }
    flags[i] = (unsigned char)((alive ? 2 : 0) | (link ? 1 : 0));
  }
  __syncthreads();

  // 2. end state of each chunk, scanned from an empty state
  const int chunk = (len + T - 1) / T;
  const int lo = min(t * chunk, len);
  const int hi = min(lo + chunk, len);
  {
    int last_head = -1, w = 0;
    for (int i = lo; i < hi; ++i) {
      int f = flags[i];
      if (f == 2) { last_head = i; w = ssize[base + i]; }
      else if (f & 1) w += ssize[base + i];
    }
    agg_head[t] = last_head;
    agg_w[t] = w;
    for (int s = 0; s < S; ++s) {
      const float* row = sv + (long long)s * M + base;
      float acc = 0.f;
      for (int i = lo; i < hi; ++i) {
        int f = flags[i];
        float x = __fmul_rn(row[i], (float)ssize[base + i]);
        if (f == 2) acc = x;
        else if (f & 1) acc = __fadd_rn(acc, x);
      }
      agg_v[s * T + t] = acc;
    }
  }
  __syncthreads();

  // 3. exclusive carries: lane s < S scans value row s, lane S the ints
  for (int lane = t; lane <= S; lane += T) {
    if (lane < S) {
      float c = 0.f;
      for (int j = 0; j < T; ++j) {
        float a = agg_v[lane * T + j];
        agg_v[lane * T + j] = c;
        c = agg_head[j] >= 0 ? a : __fadd_rn(c, a);
      }
    } else {
      int cw = 0, ch = -1;
      for (int j = 0; j < T; ++j) {
        int a = agg_w[j], hh = agg_head[j];
        agg_w[j] = cw;
        carry_head[j] = ch;
        if (hh >= 0) { cw = a; ch = hh; }
        else cw += a;
      }
    }
  }
  __syncthreads();

  // 4. rescan from the carry and write the outputs
  {
    int head = carry_head[t], w = agg_w[t];
    for (int i = lo; i < hi; ++i) {
      long long p = base + i;
      int f = flags[i];
      bool alive = f & 2, link = f & 1;
      bool next_link = (i + 1 < len) && (flags[i + 1] & 1);
      bool last = alive && !next_link;
      int sz = ssize[p];
      if (alive && !link) { head = i; w = sz; }
      else if (link) w += sz;
      int head_slot = alive ? sslot[base + head] : 0;
      out_size[p] = last ? w : (alive ? 0 : sz);
      if (out_mi)
        out_mi[p] = (alive && !last) ? head_slot : (smi ? smi[p] : -1);
      if (last) {
        out_slot[p] = head_slot;
        if (head != i) {   // the last member's slot moves to the head and dies
          out_slot[base + head] = sslot[p];
          if (parent) parent[sslot[p]] = head_slot;
        }
      } else if (link) {
        out_slot[p] = sslot[p];
        if (parent) parent[sslot[p]] = head_slot;
      } else if (!alive) {
        out_slot[p] = sslot[p];
      }   // a head that is not last: written by its chain's last member
    }
    for (int s = 0; s < S; ++s) {
      const float* row = sv + (long long)s * M + base;
      float* orow = out_v + (long long)s * M + base;
      float acc = agg_v[s * T + t];
      int ww = agg_w[t];
      for (int i = lo; i < hi; ++i) {
        int f = flags[i];
        bool alive = f & 2, link = f & 1;
        bool next_link = (i + 1 < len) && (flags[i + 1] & 1);
        int sz = ssize[base + i];
        float x = row[i];
        float wx = __fmul_rn(x, (float)sz);
        if (alive && !link) { acc = wx; ww = sz; }
        else if (link) { acc = __fadd_rn(acc, wx); ww += sz; }
        orow[i] = (alive && !next_link)
                      ? __fdiv_rn(acc, (float)max(ww, 1)) : x;
      }
    }
  }
}

KL_EXPORT int kl_chain_collapse(const void* sv, int S, long long M,
                                const void* ssize, const void* sslot,
                                const void* skey, const void* smi, float thr,
                                int free_bits, void* out_v, void* out_size,
                                void* out_slot, void* out_mi, void* parent,
                                void* stream) {
  int threads = 256;
  size_t smem = 0;
  for (; threads >= 32; threads >>= 1) {
    smem = KL_TILE + (size_t)threads * (3 * sizeof(int) + S * sizeof(float));
    if (smem <= 227 * 1024) break;
  }
  if (threads < 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kl_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((M + KL_TILE - 1) / KL_TILE);
  kl_chain_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)sv, S, M, (const int*)ssize, (const int*)sslot,
      (const int*)skey, (const int*)smi, thr, free_bits, (float*)out_v,
      (int*)out_size, (int*)out_slot, (int*)out_mi, (int*)parent);
  return (int)cudaGetLastError();
}
