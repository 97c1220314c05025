// Bloom filter insert and probe for Hopper (sm_90a) on a packed bit table.
//
// The reference has no Pallas kernel here. These replace its XLA functions in
// pplp_tpu/primitives/bloom.py -- _insert_scan_fn, _contains_fn and the size
// chain's _chain_indices / _chain_insert_fn / _chain_contains_fn -- and its
// native library's pplp_bf_indices_u64 / pplp_bf_insert_u64
// (native/pplp_native.cc:135, :157), whose packed table this one follows.
//
// The table is ceil(table_size / 32) u32 words: bit i is bit (i & 31) of word
// i >> 5. On a little-endian host the words' bytes are
// np.packbits(bits, bitorder="little"), the wire format, so serializing the
// filter copies the words as they are (sliced to table_size / 8 bytes).
//
// One thread per key. A key is the 8-byte value lo | hi << 32 from one of
// three sources, chosen at compile time:
//   kWords           (lo, hi) int64 word arrays (insert_u64_batch,
//                    contains_u64_batch);
//   kBlinded         ((s (start + i + r) mod 2^64) << w_len) | w, the server's
//                    blinded candidates (blinding.blind_distance_keys fused:
//                    the demo's whole r^2 insert is one launch);
//   kBlindDistances  ((bd[i] << w_len) | w) from int64 blind distances below
//                    2^32 (pipeline.blinded_keys fused into the probe).
// For every salt: one 8-byte round of the AP hash (bloomfilter.h's hash_ap, as
// pplp_native.cc:143-151 runs it), murmur3's fmix32 in "mixed" mode, then the
// reduction by each size of the chain in turn (one size for a plain filter,
// the historical sizes for a compressed one). Everything is u32:
// table_size < 2^32 (3,859,468,176 bits at r = 8192 is above 2^31, so no
// index may be signed), and word indices are below 2^27. The salts (at most
// 128) and the size chain (at most 32) are copied into shared memory by each
// block.
//
// bf_insert sets each bit with an atomicOr whose result is unused (a RED).
// bf_probe reads the word of each salt and stops at the first clear bit, as
// the reference's contains does; a table of at most kStageWords words (44 KB;
// 23.5 KB at the packed pipeline's r = 99) is staged in shared memory by every
// block, which then walks the keys in a grid-stride loop; a larger one is
// read from device memory.
//
// What bounds them: at the demo's sizes the table (120.6 MB at r = 4096,
// 482.4 MB at r = 8192) is larger than the 50 MB L2, so every bit set reads
// and writes one 32-byte sector at random: 671M bit sets x 64 B / 3.35 TB/s
// = 12.8 ms at r = 4096 and 40 salts, 51 ms at r = 8192. The probe reads one
// sector per salt it tests. Hashing is ~30 integer operations an index, well
// below either. The design keeps the table packed (8x fewer bytes than the
// byte-per-bit table, and no packing pass before the wire), makes the keys in
// registers, and issues the scatter as fire-and-forget REDs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSalts = 128;
constexpr int kMaxSizes = 32;
constexpr int kThreads = 256;
constexpr int64_t kStageWords = 11264;  // 44 KB of dynamic shared memory
constexpr int kStagedBlocksPerSm = 2;

enum Source : int { kWords = 0, kBlinded = 1, kBlindDistances = 2 };

// By value: the hash's parameters.
struct Chain {
  uint32_t size[kMaxSizes];
  int n_sizes;
  int n_salts;
  int mixed;
};

// By value: where the keys come from (see Source).
struct Keys {
  const int64_t* lo;  // kWords: low words; kBlindDistances: blind distances
  const int64_t* hi;  // kWords: high words
  uint64_t s, r, start;  // kBlinded
  uint32_t w;
  int w_len;
  int64_t count;
};

template <int kSource>
__device__ __forceinline__ uint64_t key_at(const Keys& k, int64_t i) {
  if constexpr (kSource == kWords) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(k.hi[i])) << 32) |
           static_cast<uint32_t>(k.lo[i]);
  } else if constexpr (kSource == kBlinded) {
    const uint64_t bd = k.s * (k.start + static_cast<uint64_t>(i) + k.r);  // mod 2^64
    return (bd << k.w_len) | k.w;
  } else {
    return (static_cast<uint64_t>(k.lo[i]) << k.w_len) | k.w;
  }
}

__device__ __forceinline__ uint32_t bit_index(uint32_t h, uint64_t key, int mixed,
                                              const uint32_t* sizes, int n_sizes) {
  const uint32_t i1 = static_cast<uint32_t>(key);
  const uint32_t i2 = static_cast<uint32_t>(key >> 32);
  h ^= (h << 7) ^ (i1 * (h >> 3)) ^ (~((h << 11) + (i2 ^ (h >> 5))));
  if (mixed) {  // murmur3 fmix32
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
  }
  for (int j = 0; j < n_sizes; ++j) h %= sizes[j];
  return h;
}

__device__ __forceinline__ void load_chain(uint32_t* s_salt, uint32_t* s_size,
                                           const int64_t* __restrict__ salts,
                                           const Chain& chain) {
  for (int j = threadIdx.x; j < chain.n_salts; j += blockDim.x)
    s_salt[j] = static_cast<uint32_t>(salts[j]);
  for (int j = threadIdx.x; j < chain.n_sizes; j += blockDim.x) s_size[j] = chain.size[j];
}

template <int kSource>
__global__ void __launch_bounds__(kThreads)
    bf_insert_kernel(uint32_t* __restrict__ words, const int64_t* __restrict__ salts,
                     const Chain chain, const Keys keys) {
  __shared__ uint32_t s_salt[kMaxSalts];
  __shared__ uint32_t s_size[kMaxSizes];
  load_chain(s_salt, s_size, salts, chain);
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= keys.count) return;
  const uint64_t key = key_at<kSource>(keys, i);
  for (int j = 0; j < chain.n_salts; ++j) {
    const uint32_t idx = bit_index(s_salt[j], key, chain.mixed, s_size, chain.n_sizes);
    atomicOr(words + (idx >> 5), 1u << (idx & 31));
  }
}

template <int kSource, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    bf_probe_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                    const int64_t* __restrict__ salts, const Chain chain, const Keys keys,
                    uint8_t* __restrict__ out) {
  __shared__ uint32_t s_salt[kMaxSalts];
  __shared__ uint32_t s_size[kMaxSizes];
  extern __shared__ uint32_t s_table[];
  load_chain(s_salt, s_size, salts, chain);
  const uint32_t* table = words;
  if constexpr (kStaged) {
    for (int64_t j = threadIdx.x; j < n_words; j += kThreads) s_table[j] = words[j];
    table = s_table;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < keys.count; i += stride) {
    const uint64_t key = key_at<kSource>(keys, i);
    uint8_t hit = 1;
    for (int j = 0; j < chain.n_salts; ++j) {
      const uint32_t idx = bit_index(s_salt[j], key, chain.mixed, s_size, chain.n_sizes);
      if (!((table[idx >> 5] >> (idx & 31)) & 1u)) {
        hit = 0;
        break;
      }
    }
    out[i] = hit;
  }
}

// Checks shared by both entry points; fills `chain` from the host array
// `sizes`. Returns 0 or cudaErrorInvalidValue.
int make_chain(Chain* chain, int n_salts, const void* sizes, int n_sizes, int mixed,
               int source, int w_len, long long count) {
  if (n_salts < 1 || n_salts > kMaxSalts || n_sizes < 1 || n_sizes > kMaxSizes ||
      source < kWords || source > kBlindDistances || w_len < 0 || w_len > 63 || count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sz = static_cast<const uint32_t*>(sizes);
  for (int j = 0; j < n_sizes; ++j) {
    if (sz[j] == 0) return static_cast<int>(cudaErrorInvalidValue);
    chain->size[j] = sz[j];
  }
  chain->n_sizes = n_sizes;
  chain->n_salts = n_salts;
  chain->mixed = mixed != 0;
  return 0;
}

}  // namespace

extern "C" {

// words: int32 [ceil(table_size / 32)] on the device, updated in place;
// salts: int64 [n_salts] on the device; sizes: u32 [n_sizes] in host memory,
// the chain ending at table_size. source kWords: lo, hi int64 [count];
// kBlinded: s, r, start, w, w_len (lo, hi unused). Returns cudaGetLastError()
// after the launch (none for count = 0).
int pplp_bf_insert(void* words, const void* salts, int n_salts, const void* sizes,
                   int n_sizes, int mixed, int source, const void* lo, const void* hi,
                   unsigned long long s, unsigned long long r, unsigned long long start,
                   unsigned w, int w_len, long long count, void* stream) {
  Chain chain;
  const int bad = make_chain(&chain, n_salts, sizes, n_sizes, mixed, source, w_len, count);
  if (bad) return bad;
  if (source == kBlindDistances) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const Keys keys{static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi), s, r,
                  start, w, w_len, count};
  const auto blocks = static_cast<unsigned>((count + kThreads - 1) / kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<uint32_t*>(words);
  const auto* sl = static_cast<const int64_t*>(salts);
  if (source == kWords)
    bf_insert_kernel<kWords><<<blocks, kThreads, 0, st>>>(out, sl, chain, keys);
  else
    bf_insert_kernel<kBlinded><<<blocks, kThreads, 0, st>>>(out, sl, chain, keys);
  return static_cast<int>(cudaGetLastError());
}

// words: int32 [n_words] on the device; salts, sizes as for pplp_bf_insert.
// source kWords: lo, hi int64 [count]; kBlindDistances: lo the blind
// distances int64 [count] (below 2^32), w, w_len. out: uint8 [count] on the
// device, 1 where every salt's bit is set.
int pplp_bf_probe(const void* words, long long n_words, const void* salts, int n_salts,
                  const void* sizes, int n_sizes, int mixed, int source, const void* lo,
                  const void* hi, unsigned w, int w_len, long long count, void* out,
                  void* stream) {
  Chain chain;
  const int bad = make_chain(&chain, n_salts, sizes, n_sizes, mixed, source, w_len, count);
  if (bad) return bad;
  if (source == kBlinded || n_words < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const Keys keys{static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi), 0, 0, 0,
                  w, w_len, count};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tw = static_cast<const uint32_t*>(words);
  const auto* sl = static_cast<const int64_t*>(salts);
  auto* o = static_cast<uint8_t*>(out);
  int64_t blocks = (count + kThreads - 1) / kThreads;
  if (n_words <= kStageWords) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 132) * kStagedBlocksPerSm;
    if (blocks > cap) blocks = cap;
    const size_t smem = static_cast<size_t>(n_words) * sizeof(uint32_t);
    if (source == kWords)
      bf_probe_kernel<kWords, true><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
          tw, n_words, sl, chain, keys, o);
    else
      bf_probe_kernel<kBlindDistances, true>
          <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(tw, n_words, sl, chain, keys, o);
  } else {
    if (source == kWords)
      bf_probe_kernel<kWords, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          tw, n_words, sl, chain, keys, o);
    else
      bf_probe_kernel<kBlindDistances, false>
          <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(tw, n_words, sl, chain, keys, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
