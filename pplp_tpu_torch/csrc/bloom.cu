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
// A key is the 8-byte value lo | hi << 32 from one of three sources, chosen
// at compile time:
//   kWords           (lo, hi) int64 word arrays (insert_u64_batch,
//                    contains_u64_batch);
//   kBlinded         ((s (start + i + r) mod 2^64) << w_len) | w, the server's
//                    blinded candidates (blinding.blind_distance_keys fused:
//                    the demo's keys are made in the kernels);
//   kBlindDistances  ((bd[i] << w_len) | w) from int64 blind distances below
//                    2^32 (pipeline.blinded_keys fused into the probe).
// For every salt: one 8-byte round of the AP hash (bloomfilter.h's hash_ap, as
// pplp_native.cc:143-151 runs it), murmur3's fmix32 in "mixed" mode, then the
// reduction by each size of the chain in turn (one size for a plain filter,
// the historical sizes for a compressed one). Everything is u32:
// table_size < 2^32 (3,859,468,176 bits at r = 8192 is above 2^31, so no
// index, bucket or offset may be signed), and word indices are below 2^27.
// The salts (at most 128) and the size chain (at most 32) are copied into
// shared memory by each block.
//
// The insert takes one of three routes, by the table's size (the wrapper,
// ops/bloom_cuda.py, decides; its constants come from the measurements below):
// * direct (bf_insert): one thread a key, each bit an atomicOr whose result
//   is unused (a RED), one launch. A table of at most 44 MB stays in L2,
//   and there it runs at the L2's rate of REDs; it takes the tables below
//   16.8 MB, and those that get fewer than two indices a word.
// * sub-slice, for a table of 16.8 to 44 MB: the table is cut into buckets,
//   sub-slices of 2^sub_log = 2^19 bits (64 KB, the shared memory of a
//   block), at most kMaxSubBuckets of them (614 at the client/server
//   filter), and the keys into chunks whose stash of u32 indices is at most
//   3.75 tables. Each chunk is three launches: bf_insert_sub_count
//   hashes every (key, salt), a key a thread, and counts its bucket in
//   shared memory; bf_insert_sub_scatter hashes again into a raw tile in
//   shared memory, reserves each bucket's run of the stash (offset: the
//   exclusive scan of the totals, taken on the device; plus one atomicAdd
//   on its cursor), sorts the tile by bucket and writes it out in runs;
//   bf_insert_sub_apply runs one block a bucket: the bucket's words into
//   shared memory, its run of the stash set by shared-memory atomicOr, each
//   word stored back once, no global atomic.
// * partitioned: the table is cut into buckets, slices of S = 2^27 bits
//   (16.8 MB), at most kMaxBuckets of them, and the keys into chunks whose
//   stash of u32 indices (chunk keys x salts x 4 B, with the blocks'
//   histograms) is no larger than the table. Each chunk is three launches:
//   bf_insert_count hashes every (key, salt) and counts its bucket in shared
//   memory; bf_insert_scatter hashes again, sorts each block's indices by
//   bucket in shared memory and writes them as contiguous runs into the
//   stash, each bucket's run reserved by one atomicAdd on its cursor, its
//   offset the exclusive scan of the counts, taken on the device (no host
//   sync in an insert); bf_insert_apply reads the stash in order and REDs
//   each index into the table, one slice live in L2 at a time. The words
//   are the direct kernel's, bit for bit: OR commutes.
// bf_probe reads the word of each salt and stops at the first clear bit, as
// the reference's contains does, one launch. Every index is reduced by
// fastmod (a reciprocal made once a call on the host: two wide multiplies
// and a product, not a remainder's division sequence), and each salt's
// index is hashed while the word of the salt before it is in flight. A
// table of at most kStageWords words (44 KB; 23.5 KB at the packed
// pipeline's r = 99) is staged in shared memory: one block an SM, sized to
// spread the keys over every SM; thread 0 starts one bulk copy
// (cp.async.bulk on an mbarrier) of the table's 16-byte body, the others copy
// the ragged tail and the salts, and every thread hashes its first salt
// before it waits for the copy. A larger table is read from device memory,
// one thread a key. A key's salts are tested one at a time; groups of salts
// whose words load together were measured and rejected (below).
//
// The constants, measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (measure_bloom --sweep: the direct kernel's bit sets/s against the table's
// size, each table filled to half its bits; at 40 and at 13 salts alike):
// 89.1G bit sets/s at 8 MB, 90.5G at 2^27 bits (16.8 MB), 82.0G at 2^28
// (33.6 MB), 80.8G at 40 MB, 80.5G at 44 MB, 67.0-74.0G at 48 MB (two
// runs), 24.2G at 2^29 (67.1 MB) and 17.9G at 120 MB. So a table of at most
// 44 MB (352,000,000 bits) is not partitioned: the largest at the L2 rate,
// which takes the client/server filter (40.2 MB, 13 salts). The rule "the largest
// power of two within 80% of the smallest table's rate" gives 2^28, but the
// same sweep's partitioned inserts ran 2^27 faster: at r = 4096, 14.06 ms
// against 18.15 ms at 2^28 (r = 8192: 54.92 against 73.22 ms), because
// the apply's blocks in flight (~1M indices) span one to two buckets, and
// two slices of 2^28 bits (67 MB) outgrow the L2; 2^26 ran 3-4% faster
// still but needs 58 buckets at r = 8192, above kMaxBuckets. One 16-byte
// load a thread in the apply ran 7% (r = 4096) and 14% (r = 8192) faster
// than four, which put ~4M indices in flight.
//
// The sub-slice route's constants, measured on an NVIDIA H100 80GB HBM3 at
// 700.00 W (measure_bloom --sweep: the route beside the direct kernel on the
// same blinded keys, each table at its optimal keys, medians of 3 rounds,
// the words held equal): at 2^19-bit sub-slices and a stash of 4x the table
// the direct kernel's time over the route's was 0.06-0.16x at 0.125-0.5 MB
// (the route's three launches and the counts' zero fill), 0.25 at 1 MB,
// 0.38-0.39 at 2 MB, 0.53-0.54 at 4 MB, 0.76-0.80 at 8 MB, 1.02-1.07 at
// 16 MB, 1.14-1.21 at 24 MB, 1.12-1.13 at 32 MB, 1.17-1.19 at the
// client/server table (40.2 MB) and 1.19-1.22 at 44 MB, at 40 and 13
// salts. So the route starts at 2^27 bits (16.8 MB). At 2^20 bits it lost
// everywhere (0.84-0.94x from 32 MB up): one 128 KB block an SM in the
// apply. On the client/server table the stash caps of
// 1x, 2x and 4x (23, 12 and 6 chunks) ran 0.90, 1.06 and 1.19x: each chunk
// moves the table through shared memory. The cap is 3.75 tables: the
// same 6 chunks as 4 there, and room in four tables for the allocator's
// rounding of the stash's block (at 4x the insert added 161,525,248 B, four
// tables and 690,832 B). A sixteenth of the table's optimal keys (1.4
// indices a word) ran 1.01x, a sixty-fourth 0.58x, hence two indices a word.
// Design experiments (measure_bloom --split on copies of this file, the
// client/server table, device ms of count, scatter, apply; direct 2.76):
// as built 0.35, 1.17, 0.79, 2.31 in all; the count over a thread's sixteen
// consecutive (key, salt) elements, the key reloaded inside the loop, 0.64
// (a key a thread, its salts unrolled by 4 and the salts' terms the same
// for the warp, lets the hashes overlap); 1,024 apply threads 0.96 against
// 512's 0.79 (three 64 KB blocks an SM; at 2^20 bits 1.07 against 1.83,
// but 2.40 in all); tiles of 4,096 indices 1.59 in the scatter, of 16,384
// 1.19.
//
// The probe's constants, measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (measure_bloom --probe on copies of this file with a key's salts tested in
// groups, a group's words loaded together and the key stopped at the first
// group with a clear bit; device time, median of 3): groups of 1, 2, 4, 8
// and 16 salts took 0.00657, 0.00664, 0.00707, 0.00697
// and 0.00686 ms at config[3] (102,400 keys, 13 salts, staged); 0.02172,
// 0.02296, 0.02530, 0.03041 and 0.03543 ms on the client/server filter
// (40.2 MB, 13 salts, 200,000 keys); 0.10841 to 0.14267 ms on the demo's
// r = 4096 table (120.6 MB, 40 salts) and 0.13253 to 0.17415 ms at r = 8192
// (482.4 MB), each rising with the group. 200,000 threads already keep
// enough reads in flight, so a group's extra words (up to 1.33x the tested
// ones at 16) cost more than its fewer round trips save, so a key's salts
// are tested one at a time. The staged blocks:
// one of 1,024 threads an SM ran 0.00697 ms, two of 512 0.00765 and four of
// 256 0.00856 (groups of 8). The parent's probe took 0.00955, 0.02284,
// 0.11180 and 0.14249 ms on the same four (one thread a key, a remainder a
// size, the table copied a word a thread by 264 blocks of 256).
//
// What bounds them. Direct, a table above the L2: each bit set reads and
// writes a random 32-byte sector (the sector model, 671M x 64 B / 3.35 TB/s
// = 12.8 ms at r = 4096, 51.3 ms at r = 8192); it ran 37.6 / 185.9 ms. The
// partitioned insert does not pay that model: its REDs land in an
// L2-resident slice, and what it moves through device memory is the stash
// (written and read, 8 B an index: 1.6 ms at r = 4096, 6.4 ms at r = 8192)
// and the table, into L2 and back once a chunk (1.7 / 6.6 ms at 23 chunks),
// plus hashing each index twice (~25 integer operations each at 1.67e13/s:
// 2.0 / 8.0 ms). That sum is the design's floor (5.3 / 21.1 ms,
// measure_bloom.design_floor); above it, the apply's REDs at the L2's rate
// (671M / 2.68G at ~80G/s: 8.4 / 33.5 ms) set the pace. The probe reads one
// sector per salt it tests.
//
// The sub-slice route at the client/server table (218M indices, 6 chunks)
// moves the stash once each way (8 B an index: 0.52 ms) and the table into
// shared memory and back once a chunk (0.14 ms), and hashes each index
// twice: measured, a pass of hashing costs ~0.35 ms (the count kernel),
// about twice the ~25 integer operations an index at MULS_PER_S that
// measure_bloom.design_floor counts (1.32 ms in all); the direct kernel's
// REDs take 2.76 ms.
//
// Rejected: hashing every key again for each L2-sized pass, with no stash.
// At r = 8192 that is 15-30 passes of 2.68G indices at ~25 integer
// operations each; at MULS_PER_S = 1.67e13/s ~4 ms a pass, 60-120 ms of
// hashing before one bit is set, and the cost grows with table / L2 x keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSalts = 128;
constexpr int kMaxSizes = 32;
constexpr int kThreads = 256;
// The probe. A table of at most kStageWords words (44 KB) is staged in shared
// memory: one block of kStagedThreads threads an SM. A larger one is read
// from device memory, kThreads threads a block, at most kDeviceBlocksPerSm
// blocks an SM.
constexpr int64_t kStageWords = 11264;
constexpr int kStagedThreads = 1024;
constexpr int kStagedBlocksPerSm = 1;
constexpr int kDeviceBlocksPerSm = 8;
constexpr int kMaxDevices = 64;
// The partitioned insert: at most kMaxBuckets slices of a table, a block's
// tile of at most kTileElems (key, salt) indices sorted in shared memory
// (40 KB: 256 keys at 40 salts, 80 at 128), and one 16-byte load of the
// stash a thread of the apply kernel.
constexpr int kMaxBuckets = 32;
constexpr int kTileElems = 10240;
constexpr int kApplyElems = kThreads * 4;  // indices a block applies
// The sub-slice insert: buckets of 2^sub_log bits (kMinSubLog to kMaxSubLog:
// 16 bytes to 128 KB of words), at most kMaxSubBuckets of them. The count
// kernel runs as many blocks of kSubThreads as are resident at once over the
// chunk's keys, a key a thread; the scatter one block of kSubScatterThreads a
// tile of sub_tile_keys(n_salts) keys (at most kSubTile indices); the apply
// one block of kSubApplyThreads a bucket.
constexpr int kSubThreads = 512;
constexpr int kSubScatterThreads = 512;
constexpr int kSubTile = 8192;
constexpr int kMaxSubBuckets = 1024;
constexpr int kMinSubLog = 7;
constexpr int kMaxSubLog = 20;
constexpr int kSubApplyThreads = 512;

// Keys in a scatter block's tile: kSubTile / n_salts, rounded down to whole
// rounds of kSubScatterThreads where that leaves at least one.
__host__ __device__ constexpr int sub_tile_keys(int n_salts) {
  return kSubTile / n_salts >= kSubScatterThreads
             ? kSubTile / n_salts / kSubScatterThreads * kSubScatterThreads
             : kSubTile / n_salts;
}

enum Source : int { kWords = 0, kBlinded = 1, kBlindDistances = 2 };

// By value: the hash's parameters. mul[j] = ceil(2^64 / size[j]) mod 2^64,
// the reciprocal that fastmod reduces by, made on the host side of the entry
// points from the sizes.
struct Chain {
  uint64_t mul[kMaxSizes];
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

// h mod d for every u32 h and d in [1, 2^32), from mul = ceil(2^64 / d) mod
// 2^64 (Lemire, Kaser and Kurz, "Faster Remainder by Direct Computation",
// 2019): the high word of (mul h mod 2^64) d, formed from 32-bit halves.
// Two wide multiplies and the low word's product, in place of the division
// sequence of a remainder by a run-time divisor. d = 1 has mul 0: h mod 1 = 0.
__device__ __forceinline__ uint32_t fastmod(uint32_t h, uint64_t mul, uint32_t d) {
  const uint64_t low = mul * h;
  const uint64_t lo = static_cast<uint32_t>(low), hi = low >> 32;
  return static_cast<uint32_t>((hi * d + ((lo * d) >> 32)) >> 32);
}

// The bit index from the AP round's result h: fmix32 in "mixed" mode, then
// the reduction by each size of the chain in turn.
__device__ __forceinline__ uint32_t mix_reduce(uint32_t h, const Chain& c) {
  if (c.mixed) {  // murmur3 fmix32
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
  }
  h = fastmod(h, c.mul[0], c.size[0]);
  for (int j = 1; j < c.n_sizes; ++j) h = fastmod(h, c.mul[j], c.size[j]);
  return h;
}

// The bit index of `key` at salt h: one AP round, then mix_reduce. Every
// Bloom kernel takes its indices from here or from salt_terms.
__device__ __forceinline__ uint32_t bit_index(uint32_t h, uint64_t key, const Chain& c) {
  const uint32_t i1 = static_cast<uint32_t>(key);
  const uint32_t i2 = static_cast<uint32_t>(key >> 32);
  return mix_reduce(h ^ (h << 7) ^ (i1 * (h >> 3)) ^ (~((h << 11) + (i2 ^ (h >> 5)))), c);
}

// A salt's AP-round terms that do not depend on the key, (h ^ (h << 7),
// h >> 3, h << 11, h >> 5), so that bit_index(h, key, c) is
// mix_reduce(t.x ^ (i1 t.y) ^ ~(t.z + (i2 ^ t.w)), c): one 16-byte shared
// load and four operations for the round's nine.
__device__ __forceinline__ uint4 salt_terms(uint32_t h) {
  return make_uint4(h ^ (h << 7), h >> 3, h << 11, h >> 5);
}

__device__ __forceinline__ uint32_t bit_index(const uint4& t, uint64_t key, const Chain& c) {
  const uint32_t i1 = static_cast<uint32_t>(key);
  const uint32_t i2 = static_cast<uint32_t>(key >> 32);
  return mix_reduce(t.x ^ (i1 * t.y) ^ (~(t.z + (i2 ^ t.w))), c);
}

__device__ __forceinline__ void load_salts(uint32_t* s_salt, const int64_t* __restrict__ salts,
                                           int n_salts) {
  for (int j = threadIdx.x; j < n_salts; j += blockDim.x)
    s_salt[j] = static_cast<uint32_t>(salts[j]);
}

__device__ __forceinline__ void load_salt_terms(uint4* s_terms, const int64_t* __restrict__ salts,
                                                int n_salts) {
  for (int j = threadIdx.x; j < n_salts; j += blockDim.x)
    s_terms[j] = salt_terms(static_cast<uint32_t>(salts[j]));
}

template <int kSource>
__global__ void __launch_bounds__(kThreads)
    bf_insert_kernel(uint32_t* __restrict__ words, const int64_t* __restrict__ salts,
                     const Chain chain, const Keys keys) {
  __shared__ uint32_t s_salt[kMaxSalts];
  load_salts(s_salt, salts, chain.n_salts);
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= keys.count) return;
  const uint64_t key = key_at<kSource>(keys, i);
  for (int j = 0; j < chain.n_salts; ++j) {
    const uint32_t idx = bit_index(s_salt[j], key, chain);
    atomicOr(words + (idx >> 5), 1u << (idx & 31));
  }
}

// By value: the partition of one chunk of keys. A block takes tile_keys
// keys (thread t < tile_keys the key start + blockIdx.x * tile_keys + t of
// the source) and their n_salts indices; bucket = idx >> slice_log.
struct Part {
  int tile_keys;
  int slice_log;
  int n_buckets;
};

// a. count: each block's histogram of buckets in shared memory, written to
// hist[blockIdx.x][b]; the chunk's totals[b] summed by one atomicAdd a
// (block, bucket).
template <int kSource>
__global__ void __launch_bounds__(kThreads)
    bf_insert_count_kernel(const int64_t* __restrict__ salts, const Chain chain,
                           const Keys keys, const Part part, uint32_t* __restrict__ hist,
                           uint32_t* __restrict__ totals) {
  __shared__ uint32_t s_salt[kMaxSalts];
  __shared__ uint32_t s_hist[kMaxBuckets];
  load_salts(s_salt, salts, chain.n_salts);
  if (threadIdx.x < kMaxBuckets) s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * part.tile_keys + threadIdx.x;
  if (static_cast<int>(threadIdx.x) < part.tile_keys && i < keys.count) {
    const uint64_t key = key_at<kSource>(keys, i);
    for (int j = 0; j < chain.n_salts; ++j) {
      const uint32_t idx = bit_index(s_salt[j], key, chain);
      atomicAdd(s_hist + (idx >> part.slice_log), 1u);
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < part.n_buckets) {
    const uint32_t c = s_hist[threadIdx.x];
    hist[static_cast<int64_t>(blockIdx.x) * part.n_buckets + threadIdx.x] = c;
    if (c) atomicAdd(totals + threadIdx.x, c);
  }
}

// b. scatter: the same tiles hashed again. The prologue takes bucket b's
// run in the stash: its chunk offset (the exclusive scan of totals), plus
// what one atomicAdd on cursors[b] reserves for this block's hist count;
// and b's place in the block's sorted tile (the exclusive scan of the
// block's own hist). The tile is sorted by bucket in shared memory (a
// shared atomicAdd for each index picks its slot in its bucket's range;
// order inside a bucket is free, since OR commutes), then written out in
// order: consecutive threads write consecutive words of a run. Every count
// and offset is at most the chunk's indices (chunk keys x salts, no more
// than the table's words < 2^27), so u32 offsets and cursors cannot
// overflow.
template <int kSource>
__global__ void __launch_bounds__(kThreads)
    bf_insert_scatter_kernel(const int64_t* __restrict__ salts, const Chain chain,
                             const Keys keys, const Part part,
                             const uint32_t* __restrict__ hist,
                             const uint32_t* __restrict__ totals,
                             uint32_t* __restrict__ cursors, uint32_t* __restrict__ stash) {
  __shared__ uint32_t s_salt[kMaxSalts];
  __shared__ uint32_t s_local[kMaxBuckets];  // the bucket's first slot in s_tile
  __shared__ uint32_t s_fill[kMaxBuckets];   // its next free slot
  __shared__ uint32_t s_dst[kMaxBuckets];    // its run's first index in the stash
  __shared__ uint32_t s_tile[kTileElems];
  load_salts(s_salt, salts, chain.n_salts);
  const int b = threadIdx.x;
  if (b < part.n_buckets) {
    const uint32_t* mine = hist + static_cast<int64_t>(blockIdx.x) * part.n_buckets;
    uint32_t base = 0, local = 0;
    for (int c = 0; c < b; ++c) {
      base += totals[c];
      local += mine[c];
    }
    s_local[b] = local;
    s_fill[b] = local;
    s_dst[b] = base + (mine[b] ? atomicAdd(cursors + b, mine[b]) : 0u);
  }
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * part.tile_keys;
  const int64_t left = keys.count - first;
  const int n_keys = left < part.tile_keys ? static_cast<int>(left) : part.tile_keys;
  if (static_cast<int>(threadIdx.x) < n_keys) {
    const uint64_t key = key_at<kSource>(keys, first + threadIdx.x);
    for (int j = 0; j < chain.n_salts; ++j) {
      const uint32_t idx = bit_index(s_salt[j], key, chain);
      s_tile[atomicAdd(s_fill + (idx >> part.slice_log), 1u)] = idx;
    }
  }
  __syncthreads();
  const int n = n_keys * chain.n_salts;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const uint32_t idx = s_tile[j];
    const uint32_t bucket = idx >> part.slice_log;
    __stcs(stash + (s_dst[bucket] + (static_cast<uint32_t>(j) - s_local[bucket])), idx);
  }
}

// c. apply: the stash, sorted by bucket, read in order, 16 bytes a thread
// (streaming loads, so the table's slice keeps L2), each index a RED into
// the table. Blocks start in index order, so the blocks in flight (132 SMs
// x 8 blocks x 1,024 indices, about 1M) cover one or two buckets: about one
// slice of the table is live in L2 at a time.
__global__ void __launch_bounds__(kThreads)
    bf_insert_apply_kernel(uint32_t* __restrict__ words, const uint32_t* __restrict__ stash,
                           int64_t n) {
  const int64_t e = 4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (e + 4 <= n) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(stash + e));
    const uint32_t idx[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) atomicOr(words + (idx[q] >> 5), 1u << (idx[q] & 31));
  } else {
    for (int64_t q = e; q < n; ++q) atomicOr(words + (stash[q] >> 5), 1u << (stash[q] & 31));
  }
}

// By value: the sub-slice insert's buckets. bucket = idx >> sub_log.
struct Sub {
  int sub_log;
  int n_buckets;
};

// a[0, n) <- its exclusive prefix sums (n <= kMaxSubBuckets), by the block's
// kT threads, each a run of kSubRun(kT) entries: the runs' sums scanned
// by warp shuffles, the warps' sums in `part` (kT / 32 words) by warp 0.
// Ends synchronized.
template <int kT>
constexpr int kSubRun = (kMaxSubBuckets + kT - 1) / kT;

template <int kT>
__device__ void block_exclusive_scan(uint32_t* a, int n, uint32_t* part) {
  static_assert(kT % 32 == 0 && kT / 32 <= 32, "a scan of at most 32 warps");
  constexpr int kRun = kSubRun<kT>;
  const int t = threadIdx.x, first = t * kRun, lane = t & 31, warp = t >> 5;
  uint32_t v[kRun], sum = 0;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    v[q] = first + q < n ? a[first + q] : 0u;
    sum += v[q];
  }
  uint32_t x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kT / 32 ? part[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kT / 32) part[lane] = w;
  }
  __syncthreads();
  uint32_t run = x - sum + (warp ? part[warp - 1] : 0u);
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    if (first + q < n) a[first + q] = run;
    run += v[q];
  }
  __syncthreads();
}

// d. sub-slice count: a grid-stride loop over the chunk's keys, a key a
// thread and its salts in turn (four hashed at once: the salts' terms are
// the same for the warp), each block's histogram of buckets in shared
// memory, added into totals[b] by one atomicAdd a (block, bucket).
template <int kSource>
__global__ void __launch_bounds__(kSubThreads)
    bf_insert_sub_count_kernel(const int64_t* __restrict__ salts, const Chain chain,
                               const Keys keys, const Sub sub, uint32_t* __restrict__ totals) {
  __shared__ uint4 s_terms[kMaxSalts];
  __shared__ uint32_t s_hist[kMaxSubBuckets];
  load_salt_terms(s_terms, salts, chain.n_salts);
  for (int b = threadIdx.x; b < sub.n_buckets; b += kSubThreads) s_hist[b] = 0;
  __syncthreads();
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kSubThreads + threadIdx.x; i < keys.count;
       i += static_cast<int64_t>(gridDim.x) * kSubThreads) {
    const uint64_t k = key_at<kSource>(keys, i);
#pragma unroll 4
    for (int j = 0; j < chain.n_salts; ++j)
      atomicAdd(s_hist + (bit_index(s_terms[j], k, chain) >> sub.sub_log), 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < sub.n_buckets; b += kSubThreads)
    if (s_hist[b]) atomicAdd(totals + b, s_hist[b]);
}

// e. sub-slice scatter, one block a tile of sub_tile_keys(n_salts) keys. counts:
// totals, cursors and offsets, n_buckets u32 each. Every block scans totals
// into the buckets' offsets in the stash (block 0 also writes them for the
// apply); hashes its tile, a key a thread as the count does, into a raw tile
// in shared memory (salt-major, so a warp's stores are consecutive) and
// counts it by bucket; reserves each bucket's run with one atomicAdd on its
// cursor; sorts the raw tile by bucket into a second one (a shared atomicAdd
// for each index picks its slot; order inside a bucket is free, since OR
// commutes) and writes it out in order, consecutive threads on consecutive
// words of a run.
template <int kSource>
__global__ void __launch_bounds__(kSubScatterThreads)
    bf_insert_sub_scatter_kernel(const int64_t* __restrict__ salts, const Chain chain,
                                 const Keys keys, const Sub sub, uint32_t* __restrict__ counts,
                                 uint32_t* __restrict__ stash) {
  constexpr int kT = kSubScatterThreads;
  extern __shared__ uint32_t s_raw[];           // kSubTile, then the sorted tile
  uint32_t* s_tile = s_raw + kSubTile;
  __shared__ uint4 s_terms[kMaxSalts];
  __shared__ uint32_t s_dst[kMaxSubBuckets];    // the bucket's run's first index in the stash
  __shared__ uint32_t s_local[kMaxSubBuckets];  // its count in the tile, then its first slot
  __shared__ uint32_t s_fill[kMaxSubBuckets];   // its next free slot
  __shared__ uint32_t s_part[kT / 32];
  const int nb = sub.n_buckets, n_salts = chain.n_salts;
  const uint32_t* totals = counts;
  uint32_t* cursors = counts + nb;
  load_salt_terms(s_terms, salts, n_salts);
  for (int b = threadIdx.x; b < nb; b += kT) {
    s_dst[b] = totals[b];
    s_local[b] = 0;
  }
  __syncthreads();
  block_exclusive_scan<kT>(s_dst, nb, s_part);
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < nb; b += kT) counts[2 * nb + b] = s_dst[b];
  const int tile_keys = sub_tile_keys(n_salts);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile_keys;
  const int n_keys = keys.count - first < tile_keys ? static_cast<int>(keys.count - first)
                                                    : tile_keys;
  for (int i = threadIdx.x; i < n_keys; i += kT) {
    const uint64_t k = key_at<kSource>(keys, first + i);
#pragma unroll 4
    for (int j = 0; j < n_salts; ++j) {
      const uint32_t idx = bit_index(s_terms[j], k, chain);
      s_raw[j * n_keys + i] = idx;
      atomicAdd(s_local + (idx >> sub.sub_log), 1u);
    }
  }
  __syncthreads();
  // Each bucket's run: the reservations are all issued before the tile's
  // scan, and their results taken after it.
  uint32_t got[kSubRun<kT>];
#pragma unroll
  for (int q = 0; q < kSubRun<kT>; ++q) {
    const int b = threadIdx.x + q * kT;
    got[q] = b < nb && s_local[b] ? atomicAdd(cursors + b, s_local[b]) : 0u;
  }
  block_exclusive_scan<kT>(s_local, nb, s_part);
#pragma unroll
  for (int q = 0; q < kSubRun<kT>; ++q) {
    const int b = threadIdx.x + q * kT;
    if (b < nb) {
      s_dst[b] += got[q];
      s_fill[b] = s_local[b];
    }
  }
  __syncthreads();
  const int n = n_keys * n_salts;
  for (int e = threadIdx.x; e < n; e += kT) {
    const uint32_t v = s_raw[e];
    s_tile[atomicAdd(s_fill + (v >> sub.sub_log), 1u)] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kT) {
    const uint32_t v = s_tile[j];
    const uint32_t b = v >> sub.sub_log;
    __stcs(stash + (s_dst[b] + (static_cast<uint32_t>(j) - s_local[b])), v);
  }
}

// f. sub-slice apply, one block a bucket with indices: the bucket's words
// (2^sub_log bits, fewer in the table's last one) copied into shared memory
// with 16-byte loads, its run of the stash (streaming loads) set by
// shared-memory atomicOr, the words stored back once with plain stores. A
// block owns its words, so no global atomic; the last word's bits above the
// table size are stored as they were read.
__global__ void __launch_bounds__(kSubApplyThreads)
    bf_insert_sub_apply_kernel(uint32_t* __restrict__ words, uint32_t n_words,
                               const uint32_t* __restrict__ stash,
                               const uint32_t* __restrict__ counts, const Sub sub) {
  extern __shared__ __align__(16) uint32_t s_words[];
  const int b = blockIdx.x;
  const uint32_t n = counts[b];
  if (n == 0) return;
  const uint32_t start = counts[2 * sub.n_buckets + b];
  const uint32_t w0 = static_cast<uint32_t>(b) << (sub.sub_log - 5);
  const uint32_t span = 1u << (sub.sub_log - 5);
  const uint32_t nw = n_words - w0 < span ? n_words - w0 : span;
  const uint32_t body = nw / 4;
  auto* s4 = reinterpret_cast<uint4*>(s_words);
  auto* g4 = reinterpret_cast<uint4*>(words + w0);
  for (uint32_t j = threadIdx.x; j < body; j += kSubApplyThreads) s4[j] = g4[j];
  for (uint32_t j = 4 * body + threadIdx.x; j < nw; j += kSubApplyThreads)
    s_words[j] = words[w0 + j];
  __syncthreads();
  for (uint32_t j = threadIdx.x; j < n; j += kSubApplyThreads) {
    const uint32_t idx = __ldcs(stash + start + j);
    atomicOr(s_words + ((idx >> 5) - w0), 1u << (idx & 31));
  }
  __syncthreads();
  for (uint32_t j = threadIdx.x; j < body; j += kSubApplyThreads) g4[j] = s4[j];
  for (uint32_t j = 4 * body + threadIdx.x; j < nw; j += kSubApplyThreads)
    words[w0 + j] = s_words[j];
}

// The staged table's copy into shared memory, the probe's only inline PTX.
// stage_init: thread 0 sets up the mbarrier that the copy completes (one
// arrival, the thread that starts it). stage_start: thread 0 starts one
// bulk copy (the Tensor Memory Accelerator's 1-D cp.async.bulk) of the
// table's first `body_bytes` bytes, a multiple of 16, and arms the barrier
// with that byte count. stage_wait: a thread waits for phase 0 to complete,
// after which the copied bytes are visible to it.
__device__ __forceinline__ void stage_init(uint64_t* bar) {
  const auto b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void stage_start(uint32_t* s_table, const uint32_t* words,
                                            uint32_t body_bytes, uint64_t* bar) {
  const auto b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  const auto dst = static_cast<uint32_t>(__cvta_generic_to_shared(s_table));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(body_bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(words), "r"(body_bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void stage_wait(uint64_t* bar) {
  const auto b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  }
}

// A key's verdict from its first salt's bit index `idx`: each salt's word
// is loaded, the next salt is hashed while it is in flight, and the key
// stops at the first clear bit (a key is present only if every bit is set).
__device__ __forceinline__ uint8_t probe_key(const uint32_t* __restrict__ table, uint64_t key,
                                             uint32_t idx, const uint32_t* s_salt,
                                             const Chain& c) {
  for (int j = 1;; ++j) {
    const uint32_t w = table[idx >> 5];
    const bool more = j < c.n_salts;
    const uint32_t next = more ? bit_index(s_salt[j], key, c) : 0;
    if (!((w >> (idx & 31)) & 1u)) return 0;
    if (!more) return 1;
    idx = next;
  }
}

// The probe: a grid-stride loop over the keys, out[i] = every salt's bit set.
// Staged (kStaged, a table of at most kStageWords words): thread 0 starts
// the table's bulk copy into shared memory, the other threads copy the
// ragged tail (the words past the last 16-byte boundary; the whole table
// when its storage is not 16-byte aligned) and the salts, every thread's
// first key loads meanwhile, and every thread hashes its first salt before
// it waits for the copy. Otherwise the table is read from device memory.
template <int kSource, bool kStaged>
__global__ void __launch_bounds__(kStaged ? kStagedThreads : kThreads)
    bf_probe_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                    const int64_t* __restrict__ salts, const Chain chain, const Keys keys,
                    uint8_t* __restrict__ out) {
  const int T = blockDim.x;
  __shared__ uint32_t s_salt[kMaxSalts];
  __shared__ uint64_t s_bar;
  extern __shared__ __align__(16) uint32_t s_table[];
  int64_t body = 0;
  if constexpr (kStaged) {
    body = (reinterpret_cast<uintptr_t>(words) & 15) == 0 ? n_words & ~int64_t{3} : 0;
    if (threadIdx.x == 0) stage_init(&s_bar);
    __syncthreads();
    if (threadIdx.x == 0 && body > 0)
      stage_start(s_table, words, static_cast<uint32_t>(4 * body), &s_bar);
    for (int64_t j = body + threadIdx.x; j < n_words; j += T) s_table[j] = words[j];
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * T;
  int64_t i = static_cast<int64_t>(blockIdx.x) * T + threadIdx.x;
  const uint64_t first = i < keys.count ? key_at<kSource>(keys, i) : 0;  // under the salts' load
  load_salts(s_salt, salts, chain.n_salts);
  __syncthreads();
  uint64_t key = first;
  uint32_t idx = i < keys.count ? bit_index(s_salt[0], key, chain) : 0;
  const uint32_t* table = words;
  if constexpr (kStaged) {
    if (body > 0) stage_wait(&s_bar);
    table = s_table;
  }
  for (; i < keys.count; i += stride) {
    out[i] = probe_key(table, key, idx, s_salt, chain);
    if (i + stride < keys.count) {
      key = key_at<kSource>(keys, i + stride);
      idx = bit_index(s_salt[0], key, chain);
    }
  }
}

// An empty kernel, launched at the probe's geometry: the launch floor that
// the probe's device time is read against.
__global__ void bf_probe_floor_kernel() {}

// SMs of the current device, read once a device.
int sm_count() {
  static int sms[kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 132;
  if (sms[device] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    sms[device] = n > 0 ? n : 132;
  }
  return sms[device];
}

// Blocks of `kernel` resident on an SM at once, at `threads` threads and
// `smem` bytes of dynamic shared memory (at least 1).
template <class K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n > 0 ? n : 1;
}

// The probe's launch: staged or not, blocks, threads and dynamic shared memory.
struct ProbeLaunch {
  bool staged;
  unsigned blocks;
  int threads;
  size_t smem;
};

// Staged: one block an SM, its threads the keys an SM gets rounded up to a
// warp (at most kStagedThreads), so that the keys spread over every SM.
ProbeLaunch probe_launch(int64_t n_words, int64_t count) {
  const int64_t sms = sm_count();
  if (n_words <= kStageWords) {
    int64_t threads = (count + sms * kStagedBlocksPerSm - 1) / (sms * kStagedBlocksPerSm);
    threads = threads < kStagedThreads ? (threads + 31) / 32 * 32 : kStagedThreads;
    const int64_t blocks = (count + threads - 1) / threads;
    return {true, static_cast<unsigned>(blocks < sms * kStagedBlocksPerSm ? blocks
                                                                         : sms * kStagedBlocksPerSm),
            static_cast<int>(threads), static_cast<size_t>(n_words) * sizeof(uint32_t)};
  }
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  const int64_t cap = sms * kDeviceBlocksPerSm;
  return {false, static_cast<unsigned>(blocks < cap ? blocks : cap), kThreads, 0};
}

// Checks shared by the entry points; fills `chain` from the host array
// `sizes`, each size's fastmod multiplier with it. Returns 0 or
// cudaErrorInvalidValue.
int make_chain(Chain* chain, int n_salts, const void* sizes, int n_sizes, int mixed,
               int source, int w_len, long long count) {
  if (n_salts < 1 || n_salts > kMaxSalts || n_sizes < 1 || n_sizes > kMaxSizes ||
      source < kWords || source > kBlindDistances || w_len < 0 || w_len > 63 || count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sz = static_cast<const uint32_t*>(sizes);
  for (int j = 0; j < n_sizes; ++j) {
    if (sz[j] == 0) return static_cast<int>(cudaErrorInvalidValue);
    chain->size[j] = sz[j];
    chain->mul[j] = ~uint64_t{0} / sz[j] + 1;
  }
  chain->n_sizes = n_sizes;
  chain->n_salts = n_salts;
  chain->mixed = mixed != 0;
  return 0;
}

// Checks of one chunk of a partitioned insert (see pplp_bf_insert_count):
// fills `chain` as make_chain does and `part`. Returns 0 or
// cudaErrorInvalidValue.
int make_chunk(Chain* chain, Part* part, int n_salts, const void* sizes, int n_sizes,
               int mixed, int source, int w_len, long long count, int tile_keys,
               int slice_log, int n_buckets) {
  const int bad = make_chain(chain, n_salts, sizes, n_sizes, mixed, source, w_len, count);
  if (bad) return bad;
  const uint64_t table = chain->size[n_sizes - 1];
  if (source == kBlindDistances || tile_keys < 1 || tile_keys > kThreads ||
      tile_keys * n_salts > kTileElems || slice_log < 5 || slice_log > 31 || n_buckets < 1 ||
      n_buckets > kMaxBuckets || table > (static_cast<uint64_t>(n_buckets) << slice_log) ||
      table <= (static_cast<uint64_t>(n_buckets - 1) << slice_log) ||
      static_cast<uint64_t>(count) * n_salts > 0xFFFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  part->tile_keys = tile_keys;
  part->slice_log = slice_log;
  part->n_buckets = n_buckets;
  return 0;
}

// Checks of one chunk of a sub-slice insert (see pplp_bf_insert_sub_count):
// fills `chain` as make_chain does and `sub`. Returns 0 or
// cudaErrorInvalidValue.
int make_sub(Chain* chain, Sub* sub, int n_salts, const void* sizes, int n_sizes, int mixed,
             int source, int w_len, long long count, int sub_log, int n_buckets) {
  const int bad = make_chain(chain, n_salts, sizes, n_sizes, mixed, source, w_len, count);
  if (bad) return bad;
  const uint64_t table = chain->size[n_sizes - 1];
  if (source == kBlindDistances || sub_log < kMinSubLog || sub_log > kMaxSubLog ||
      n_buckets < 1 || n_buckets > kMaxSubBuckets ||
      table > (static_cast<uint64_t>(n_buckets) << sub_log) ||
      table <= (static_cast<uint64_t>(n_buckets - 1) << sub_log) ||
      static_cast<uint64_t>(count) * n_salts > 0x7FFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  sub->sub_log = sub_log;
  sub->n_buckets = n_buckets;
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

// The partitioned insert of one chunk of keys, in three launches on one
// stream: pplp_bf_insert_count, pplp_bf_insert_scatter,
// pplp_bf_insert_apply. salts, sizes, source and the key arguments as for
// pplp_bf_insert, for the chunk's keys (lo, hi offset to its first key;
// start its first blinded step). Every bucket is a slice of 2^slice_log
// bits; n_buckets = ceil(table_size / 2^slice_log) <= kMaxBuckets;
// tile_keys <= kThreads keys a block, at most kTileElems indices. hist: u32
// [ceil(count / tile_keys), n_buckets]; counts: u32 [2, n_buckets], zero
// before the count (the chunk's totals, then the scatter's cursors); stash:
// u32 [count * n_salts], the chunk's indices sorted by bucket.
int pplp_bf_insert_count(const void* salts, int n_salts, const void* sizes, int n_sizes,
                         int mixed, int source, const void* lo, const void* hi,
                         unsigned long long s, unsigned long long r, unsigned long long start,
                         unsigned w, int w_len, long long count, int tile_keys, int slice_log,
                         int n_buckets, void* hist, void* counts, void* stream) {
  Chain chain;
  Part part;
  const int bad = make_chunk(&chain, &part, n_salts, sizes, n_sizes, mixed, source, w_len,
                             count, tile_keys, slice_log, n_buckets);
  if (bad || count == 0) return bad;
  const Keys keys{static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi), s, r,
                  start, w, w_len, count};
  const auto blocks = static_cast<unsigned>((count + tile_keys - 1) / tile_keys);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int64_t*>(salts);
  auto* h = static_cast<uint32_t*>(hist);
  auto* totals = static_cast<uint32_t*>(counts);
  if (source == kWords)
    bf_insert_count_kernel<kWords><<<blocks, kThreads, 0, st>>>(sl, chain, keys, part, h,
                                                                 totals);
  else
    bf_insert_count_kernel<kBlinded><<<blocks, kThreads, 0, st>>>(sl, chain, keys, part, h,
                                                                   totals);
  return static_cast<int>(cudaGetLastError());
}

int pplp_bf_insert_scatter(const void* salts, int n_salts, const void* sizes, int n_sizes,
                           int mixed, int source, const void* lo, const void* hi,
                           unsigned long long s, unsigned long long r, unsigned long long start,
                           unsigned w, int w_len, long long count, int tile_keys, int slice_log,
                           int n_buckets, const void* hist, void* counts, void* stash,
                           void* stream) {
  Chain chain;
  Part part;
  const int bad = make_chunk(&chain, &part, n_salts, sizes, n_sizes, mixed, source, w_len,
                             count, tile_keys, slice_log, n_buckets);
  if (bad || count == 0) return bad;
  const Keys keys{static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi), s, r,
                  start, w, w_len, count};
  const auto blocks = static_cast<unsigned>((count + tile_keys - 1) / tile_keys);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int64_t*>(salts);
  const auto* h = static_cast<const uint32_t*>(hist);
  auto* totals = static_cast<uint32_t*>(counts);
  auto* cursors = totals + n_buckets;
  auto* out = static_cast<uint32_t*>(stash);
  if (source == kWords)
    bf_insert_scatter_kernel<kWords><<<blocks, kThreads, 0, st>>>(sl, chain, keys, part, h,
                                                                   totals, cursors, out);
  else
    bf_insert_scatter_kernel<kBlinded><<<blocks, kThreads, 0, st>>>(sl, chain, keys, part, h,
                                                                     totals, cursors, out);
  return static_cast<int>(cudaGetLastError());
}

// words: int32 [ceil(table_size / 32)] on the device, updated in place;
// stash: u32 [n] (16-byte aligned), indices below table_size.
int pplp_bf_insert_apply(void* words, const void* stash, long long n, void* stream) {
  if (n < 0 || (reinterpret_cast<uintptr_t>(stash) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto blocks = static_cast<unsigned>((n + kApplyElems - 1) / kApplyElems);
  bf_insert_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), static_cast<const uint32_t*>(stash), n);
  return static_cast<int>(cudaGetLastError());
}

// The sub-slice insert of one chunk of keys, in three launches on one
// stream: pplp_bf_insert_sub_count, pplp_bf_insert_sub_scatter,
// pplp_bf_insert_sub_apply. salts, sizes, source and the key arguments as
// for pplp_bf_insert, for the chunk's keys (lo, hi offset to its first key;
// start its first blinded step); count * n_salts < 2^31. Every bucket is a
// sub-slice of 2^sub_log bits (kMinSubLog <= sub_log <= kMaxSubLog);
// n_buckets = ceil(table_size / 2^sub_log) <= kMaxSubBuckets. counts: u32
// [3, n_buckets], the chunk's totals, cursors and offsets, the first two
// zero before the count; stash: u32 [count * n_salts], the chunk's indices
// sorted by bucket.
int pplp_bf_insert_sub_count(const void* salts, int n_salts, const void* sizes, int n_sizes,
                             int mixed, int source, const void* lo, const void* hi,
                             unsigned long long s, unsigned long long r,
                             unsigned long long start, unsigned w, int w_len, long long count,
                             int sub_log, int n_buckets, void* counts, void* stream) {
  Chain chain;
  Sub sub;
  const int bad = make_sub(&chain, &sub, n_salts, sizes, n_sizes, mixed, source, w_len, count,
                           sub_log, n_buckets);
  if (bad || count == 0) return bad;
  const Keys keys{static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi), s, r,
                  start, w, w_len, count};
  const auto kernel = source == kWords ? bf_insert_sub_count_kernel<kWords>
                                       : bf_insert_sub_count_kernel<kBlinded>;
  const int64_t tiles = (count * n_salts + kSubTile - 1) / kSubTile;
  const int64_t cap = static_cast<int64_t>(sm_count()) * resident_blocks(kernel, kSubThreads, 0);
  const auto blocks = static_cast<unsigned>(tiles < cap ? tiles : cap);
  kernel<<<blocks, kSubThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(salts), chain, keys, sub, static_cast<uint32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int pplp_bf_insert_sub_scatter(const void* salts, int n_salts, const void* sizes, int n_sizes,
                               int mixed, int source, const void* lo, const void* hi,
                               unsigned long long s, unsigned long long r,
                               unsigned long long start, unsigned w, int w_len, long long count,
                               int sub_log, int n_buckets, void* counts, void* stash,
                               void* stream) {
  Chain chain;
  Sub sub;
  const int bad = make_sub(&chain, &sub, n_salts, sizes, n_sizes, mixed, source, w_len, count,
                           sub_log, n_buckets);
  if (bad || count == 0) return bad;
  const Keys keys{static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi), s, r,
                  start, w, w_len, count};
  const int64_t tile_keys = sub_tile_keys(n_salts);
  const auto blocks = static_cast<unsigned>((count + tile_keys - 1) / tile_keys);
  constexpr size_t smem = 2 * kSubTile * sizeof(uint32_t);
  const auto kernel = source == kWords ? bf_insert_sub_scatter_kernel<kWords>
                                       : bf_insert_sub_scatter_kernel<kBlinded>;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks, kSubScatterThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(salts), chain, keys, sub, static_cast<uint32_t*>(counts),
      static_cast<uint32_t*>(stash));
  return static_cast<int>(cudaGetLastError());
}

// words: int32 [n_words] on the device (16-byte aligned), updated in place;
// stash and counts as the scatter left them. One launch of n_buckets blocks
// (a bucket without indices returns at once).
int pplp_bf_insert_sub_apply(void* words, long long n_words, const void* stash,
                             const void* counts, int sub_log, int n_buckets, void* stream) {
  if (sub_log < kMinSubLog || sub_log > kMaxSubLog || n_buckets < 1 ||
      n_buckets > kMaxSubBuckets || n_words < 1 ||
      n_words > (static_cast<long long>(n_buckets) << (sub_log - 5)) ||
      n_words <= (static_cast<long long>(n_buckets - 1) << (sub_log - 5)) ||
      (reinterpret_cast<uintptr_t>(words) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) << (sub_log - 5);
  const cudaError_t set =
      cudaFuncSetAttribute(bf_insert_sub_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sizeof(uint32_t) << (kMaxSubLog - 5));
  if (set != cudaSuccess) return static_cast<int>(set);
  bf_insert_sub_apply_kernel<<<n_buckets, kSubApplyThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), static_cast<uint32_t>(n_words),
      static_cast<const uint32_t*>(stash), static_cast<const uint32_t*>(counts),
      Sub{sub_log, n_buckets});
  return static_cast<int>(cudaGetLastError());
}

// words: int32 [n_words] on the device; salts, sizes as for pplp_bf_insert.
// source kWords: lo, hi int64 [count]; kBlindDistances: lo the blind
// distances int64 [count] (below 2^32), w, w_len. out: uint8 [count] on the
// device, 1 where every salt's bit is set. One launch (none for count = 0).
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
  const ProbeLaunch l = probe_launch(n_words, count);
  if (l.staged) {
    if (source == kWords)
      bf_probe_kernel<kWords, true><<<l.blocks, l.threads, l.smem, st>>>(tw, n_words, sl, chain,
                                                                         keys, o);
    else
      bf_probe_kernel<kBlindDistances, true><<<l.blocks, l.threads, l.smem, st>>>(
          tw, n_words, sl, chain, keys, o);
  } else {
    if (source == kWords)
      bf_probe_kernel<kWords, false><<<l.blocks, l.threads, 0, st>>>(tw, n_words, sl, chain,
                                                                      keys, o);
    else
      bf_probe_kernel<kBlindDistances, false><<<l.blocks, l.threads, 0, st>>>(
          tw, n_words, sl, chain, keys, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel at the geometry of a probe of `count` keys in a table of
// `n_words` words (its blocks, threads and dynamic shared memory).
int pplp_bf_probe_floor(long long n_words, long long count, void* stream) {
  if (n_words < 1 || count < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ProbeLaunch l = probe_launch(n_words, count);
  bf_probe_floor_kernel<<<l.blocks, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
